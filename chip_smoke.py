#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pytorchrec_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N]

Phases; any failure ends the run with a non-zero exit and no result line:

1. card: the card's name and power limit (nvidia-smi) and torch's name for it;
2. build: every CUDA kernel of the serving and training paths (cross,
   seg_scan, scatter, requantize, fm, din_attention, retrieval_topk,
   quantize), from
   ``pytorchrec_tpu_torch/csrc``, one nvcc each, all at once;
3. kernel against plain: the cross kernel's wrapper on the card at the shapes
   the serving path gives it, and at D = 513, 1677 and 2048 (past the fused
   form's width: the tiled form) at 1, 1000, 4097 and 32768 rows, with the
   form and k-slices its plan chose; at 5 rows (the rows tile). Up to
   D = 512 it is held to its plain PyTorch version (cuBLAS); past it to the
   exact sums (float64 products rounded to f32, ``cross_network_exact``):
   within rtol 1e-4 / atol 1e-6 of them, or no farther from them than
   cuBLAS is (``exact_gate``; ``ROADMAP.md`` C1). Then the gate past
   D = 512 over a grid of batches and widths at the card tests' inputs,
   with where cuBLAS splits k (a split-k reduce kernel in a
   ``torch.profiler`` trace of ``torch.mm``) beside where the plan does and
   each distance as a share of the tolerance;
4. serving: DCN-v2 at the full Criteo width (26 sparse fields of 100k ids,
   E=16, 13 dense fields, 3 cross layers, MLP 256-128; ``bench.py``'s
   config), weights made from ``--seed`` in the flax leaf layout and loaded
   through ``params_from_jax``. It scores requests of 1, 1000, 4096 and 32768
   rows and one candidate request [256, 100], once with the f32 table (the
   packed ``table || moments`` leaf) and once with the int8 packed byte-row
   table, through ``make_serving_fn``'s captured scorer: a request shape's
   first request runs eagerly, its second captures a CUDA graph, and the
   timed requests replay it. Launch counts are zeroed just before and read
   just after; each request must launch the cross kernel once (a replay
   through its graph's tally), give finite scores of the right shape and
   agree with the same model run with the plain cross network on the card
   (through a scorer made inside the swap, whose eager requests launch no
   kernel) and, for the 1000-row request, on the CPU. One more 1-row and
   one more 32768-row replay run under torch.profiler, which prints the
   device time by kernel and copy against the request's wall time;
5. cross timings: the cross kernel's time at 1, 1000, 4096 and 32768 rows,
   at D=429 and at D=1677, beside its plain version, the per-layer cuBLAS
   ``addmm`` loop and the card's bound (f32 FMA), with the form that ran;
6. training kernels against plain, on the card: the segmented scan at the
   packed update's shape (851,968 rows of E=16, ids drawn as ``bench.py``
   draws them), a Zipf-skewed case with segments of 10k+ rows, 1 and
   1000 rows, its look-back's edges at the f32 and the int8 update's layout
   (one segment over all 851,968 rows, and three calls back to back without
   a sync, exact on values whose sums are exact in f32; two calls on the
   path's own values, bit-equal), and rows of
   E = 257, 300 and 512 (chunks of 256 columns), with the launch (floats a
   load, tiles, registers, status bytes); the scatter-set into a [2.6M, 64]
   f32 table (bit-exact); the
   cross network's gradient through its autograd Function against autograd
   through the plain version at B=4096; then each kernel's time beside its
   plain version, a PyTorch yardstick where one exists, and its bound, at
   the f32 and the int8 training step's shapes;
7. training: the same model under ``SparseEmbeddingTrainer(packed_tables=
   True)`` (lazy Adam on packed ``table || m || v`` rows, dense Adam, BCE),
   weights from ``--seed`` loaded through ``params_from_jax``, 25
   ``train_step``s on device-resident batches of 32768 rows made as
   ``bench.py``'s ``make_host_batch``, then ``fit_steps`` and the trained
   model's ``make_serving_fn``. Launch counts are zeroed just before and read
   just after: every step launches each of the three kernels once. Losses
   must be finite and the packed buffer never reallocated. It prints ms/step
   and examples/s (CUDA events over the last 20 steps), a torch.profiler
   breakdown of one more step and the peak device memory;
8. card against CPU: the same model and weights, 2 steps at batch 1024 on the
   card and on the CPU (plain versions), compared loss by loss and in the
   dense parameters and touched packed rows afterwards;
9. requantize against plain, on the card: the int8 update's kernel at its
   main-path shape (851,968 permuted 128-byte rows of a random int8 table
   gathered at ``bench.py``-drawn ids, grads summed by the scan, the step-1
   salt), at 1 and 1000 rows, with an all-zero row and with lr 10, and at
   DIN's step shape (90,112 384-byte rows of E=64, the model's table lr);
   then its time beside its plain version and its bound at both shapes,
   with its launch (lanes a row, rows a warp, grid, registers) and its
   share of the bound;
10. int8 training: phase 7 under ``QuantizedEmbeddingTrainer(packed_tables=
   True)`` (rowwise Adagrad and stochastic requantization of packed
   ``q || scale || acc`` byte rows, bench.py's headline ``int8-packed``
   configuration); every step launches each of the four kernels once, and
   the packed buffer stays the model's own ``unified_q``;
11. int8 card against CPU: phase 8 for the int8 trainer;
12. FM kernels against plain, on the card: the forward and the backward at
   1, 1000 and 32768 rows and at the candidate request's [25600, 39, 16],
   forward and backward through their autograd Function against autograd
   through the plain version at B=4096, then each kernel's time beside its
   plain version and its bound at [32768, 39, 16]; the segmented scan at
   the linear table's shape (851,968 rows of E=1, row stride 64), checked
   (its look-back's edges too) and timed;
13. DeepFM serving at the same Criteo width (the FM over 39 field vectors of
   E=16, deep MLP 256-128 over their 624 values, ``deep_head`` with no
   bias), the requests of phase 4, with the f32 tables (both packed leaves,
   sliced) and with the int8 table beside the f32 linear table, captured as
   in phase 4; each request launches the FM forward kernel once and its
   backward never, and agrees with the same model run with the plain FM on
   the card (a scorer made inside the swap) and, for the 1000-row request,
   on the CPU;
14. DeepFM f32 training: phase 7 for DeepFM, with two packed tables
   (``unified_emb`` and ``unified_lin``, ``[2.6M, 64]`` each); every step
   launches the FM forward and backward once each and the scan and the
   scatter twice (once a table); then the linear table's own share of a
   step (its gather and packed update, timed alone);
15. DeepFM int8 training: phase 10 for DeepFM, the f32 linear table in the
   dense Adam; every step launches each of the five kernels once;
16. DeepFM card against CPU: phases 8 and 11 for DeepFM;
17. DIN kernels against plain, on the card: the attention-pooling kernel at
   the shapes DIN gives it (``[1, 1]``, the training step's ``[4096, 2]`` and
   the leave-one-out request's ``[1024, 100]`` candidates over 20 history
   steps, E=64, score MLP (80, 40)), plus E=8 with (16, 8), depths 1 and 3,
   a layer 160 wide, relu, E=40, a ragged ``[37, 100]`` and rows of S=129
   (two chunks a row), and forward and backward through its autograd
   Function against plain autograd at ``[4096, 2, 20]``; then its time beside
   its plain version and its bound (the least work, ``w_0`` split by blocks;
   the split form's, which the kernel runs, and the concat form's beside it)
   and its shared memory a block, at the training and the serving shape. The scan
   and scatter kernels at DIN's step shape (90,112 item ids of E=64: scan
   row stride 256 and 96, scatter of 1 KB f32 and 384-byte rows), checked
   (the scan's look-back's edges too) and timed;
18. DIN serving at the "DIN on Amazon" scale of ``scripts/din_sparse_ab.py``
   (1,048,576 items and 65,536 users of E=64, attention (80, 40), MLP
   (200, 80)), weights from ``--seed`` in the flax leaf layout through
   ``params_from_jax``: point-wise requests of 1, 1000 and 4096 rows and
   candidate requests ``[1, 100]``, ``[256, 100]`` and ``[1024, 100]``, with
   the f32 tables and with the int8 item table, captured as in phase 4;
   each request launches the pooling kernel once and agrees with the same
   model run with the plain pool on the card (a scorer made inside the
   swap) and, for ``[256, 100]``, on the CPU;
19. DIN f32 training: phase 7 for DIN at batch 4096 (2 candidates, positive
   first, 20 history steps; batches made as ``scripts/din_sparse_ab.py``
   makes them), two packed tables (``[65536, 256]`` and ``[1048576, 256]``):
   every step launches the pooling kernel once and the scan and the scatter
   twice;
20. DIN int8 training: phase 10 for DIN, the ``[1048576, 384]`` u8 ``i_q``
   table (rowwise Adagrad at the model's table lr 2e-2), the f32 user table
   in the dense Adam; every step launches the pooling, scan, requantize and
   scatter kernels once each;
21. DIN card against CPU: phase 26's check for DIN (f32 and int8) at batch
   512, each step from a common state, with Adam's eps window counted;
22. B7 against plain, on the card: the fused score + bin-max kernel at the
   serving shape (4096 unit queries x 1,000,000 unit items, D=128, tc 2048,
   group 16) in bf16 and f32, at B=1, at B=37 and D=16 with the three
   ``(V, tc, group)`` of ``tests/test_pallas_kernels.py``, at V=1 and V=100,
   at the bf16 kernel's edges (B past one 128-query tile, 5 and 300 tiles a
   super-chunk, bf16 D of 13 and 100, padded for TMA), and with duplicated
   rows (no copy ever wins: the lower id does); vals rtol 1e-4 / atol 1e-6,
   ids equal except in bins whose best and runner-up tie within that (with
   duplicated rows: where kernel and plain pick two distinct rows whose
   scores agree within it; they are counted). Then
   its time at the serving shape beside the plain version, the
   per-super-chunk cuBLAS score GEMMs alone, the exact chunked top-k and the
   bounds (bf16 tensor cores; f32 FMA), and the bf16 kernel alone at 1 and
   256 queries with its work units;
23. two-tower retrieval serving at ``scripts/retrieval_bench.py``'s scale, no
   cut (1M users and 1M items of E=64, towers (256, 128), normalized,
   temperature 0.05), weights from ``--seed`` in the flax leaf layout through
   ``params_from_jax``: the bf16 item index built and timed, fused requests
   of 1, 256 and 4096 queries at k=100, a CUDA graph each from its second
   request (each launches B7 once and agrees with the plain version on the
   card, through a retrieve function made inside the swap, which launches
   no kernel; the 256-query one with the CPU too; their
   scores are the exact scores of their ids; the 4096-query recall against
   the exact path is at least 0.975), one fused request on an f32 index,
   ``approx=True`` (the exact path), point-wise and candidate scoring through
   ``make_serving_fn`` (no B7), a profile of the 4096-query replay; the same
   with the int8 item table; the retrieve functions are dropped with the
   index their graphs hold;
24. two-tower f32 training: phase 7 for the two-tower model at batch 4096
   (``iid [B, 1]``: 4095 in-batch negatives a row), the softmax loss, lr
   1e-2, two packed ``[1000000, 256]`` f32 tables: every step launches the
   scan and the scatter twice and B7 never; then a fused retrieval from the
   trained model's rebuilt index, which launches B7 once;
25. two-tower int8 training: phase 10 for the two-tower model, the
   ``[1000000, 384]`` u8 ``i_q``, the user table in the dense Adam; every
   step launches the scan, requantize and scatter kernels once each;
26. two-tower card against CPU: phases 8 and 11 at batch 512 with
   accidental-hit masking, planted duplicate positives and a logQ column,
   each step from a common state, with Adam's eps window counted
   (``stepped_card_against_cpu`` says why);
27. B8 against plain, on the card, bit for bit (q and scale), in its keyed
   form (the kernel hashes the rows' ids and the salt) at the classic step's
   shape (the dedup of a ``bench.py`` batch's 851,968 ids, E=16, the
   table's step-1 salt), at ``[1, 1]``, ``[7, 1]``, ``[1000, 64]`` and
   ``[1000, 100]`` (ids up to 2**31 - 1, salts of 2**31 and above) and on
   edge rows (all zero, quotients on integers, values past 127 before the
   clip), and with given bits (the TPU kernel's contract) at the classic
   step's shape, ``[1000, 64]`` of random bits and the edge rows; the
   launch (lanes a row, registers, local memory); then both forms' times
   beside their plain versions and bounds, the torch hash's (the pass the
   keyed form replaces), the dedup's and the q and scale scatter-sets'
   times, and the whole classic update of a ``[2.6M, 16]`` int8 table timed
   alone;
28. classic int8 serving: phase 4's requests for DCN-v2 and DeepFM with the
   classic ``unified_q`` int8 ``[2.6M, 16]`` and ``unified_scale`` f32
   ``[2.6M]`` leaves (``table_packed=False``, the JAX package's default),
   captured and checked against plain as in phase 4; B8 never launches;
29. classic int8 DCN-v2 training: phase 7 under ``QuantizedEmbeddingTrainer
   (packed_tables=False)`` (dedup of the row grads, rowwise Adagrad, id-keyed
   stochastic requantization through B8's keyed form, scatter-set of q and
   scale, the accumulator's masked add); every step launches the cross
   kernel, the scan and B8 once each and the scatter twice, and the torch
   id-keyed hash runs never;
30. classic int8 DeepFM training: phase 29 for DeepFM (the FM forward and
   backward once a step in place of the cross kernel);
31. classic card against CPU: phases 8 and 11 for both models' classic
   tables, q values off by one in at most 0.1%;
32. the classic step against the packed step: one DCN-v2 step each from the
   same weights and table on ids unique within each field; q and scale
   bit-equal, accumulators rtol 1e-6 (B8 against B3);
33. classic int4 and two scale groups: phase 29 for each, no B8 launch (no
   TPU kernel covers them: the torch hash runs);
34. DCN-v2 at E=64, the configuration of ``scripts/int8_e64_ab.py`` (26
   fields of 100k ids, E=64, 13 dense, so the cross network's D = 1677, 3
   cross layers, MLP 256-128) with the f32 and the int8 packed tables:
   requests of 1, 4096 and 32768 rows, each against the plain cross forward
   on the card and the 4096-row one against the CPU, then phase 7's
   training run for each table; launch counts from zero, the cross kernel
   once a request and once a step (its tiled form: D is past the fused
   form's width);
35. captured steps: ``Trainer.fit_steps`` (a warm-up step, then CUDA graphs
   of 1 and 4 steps replayed) against eager ``train_step``s, for DCN-v2
   (f32, int8 packed, classic int8), DeepFM f32, DIN f32 and two-tower f32
   at the widths and batches above: two trainers from one state
   (``params_from_jax``), 18 eager steps against ``fit_steps(9,
   steps_per_call=1)`` then ``fit_steps(9, steps_per_call=4)`` (4 + 4 + a
   tail of 1) over the same host batches, launch counts from zero for each
   (every kernel as often as the eager steps launch it; each graph's tally
   a replay, its steps times the eager step's launches); every loss, dense
   parameter and table value bit-equal, or named and held to phase 21's
   tolerances. Then eager and captured ms/step (CUDA events and the host
   clock over 20 steps, the captured ones over batches packed on the
   device; eager, 1 a replay, 4 a replay, 1 a replay, eager) and a
   profiled replay of 4 steps beside a profiled eager step;
36. captured requests and evaluation, launch counts from zero: every
   request of phases 4 and 13 for DCN-v2 (f32, int8, classic) and DeepFM
   f32, and of phase 18 for DIN f32, through the eager model call
   (``serve.eager``) and through the captured scorer: bit-equal, the host
   clock's median of 5 each, a profiled replay's device time and a
   replay's launches (its graph's tally), and the memory the graphs hold;
   fused retrieval of 1, 256 and 4096 users and the exact 4096-user request
   the same way (scores and ids bit-equal), with recall@100 of the captured
   fused request against the captured exact one at least 0.975; then
   ``predict`` and ``evaluate`` (``ndcg@10``, ``hit@10``, ``auc``,
   ``logloss``, ``user_sample_n=100``) over 8 DIN batches of 1024
   leave-one-out rows of 100 candidates: ``predict`` bit-equal to the eager
   scorer, ``evaluate`` exactly ``MetricList`` of ``predict``'s output,
   ``streaming=True`` within 1e-4 for AUC and rtol 1e-6 for the others;
37. the fit loop (``Trainer.fit``) at DCN-v2's full width (``bench.py``'s,
   no cut) over an in-memory reader of 8 train batches of 32768 rows and
   49,152 dev rows (2 dev batches, the last short), f32 and int8 packed:
   2 epochs with the dev AUC and logloss after each, from a saved state,
   launch counts from zero (every step a replay of the captured step after
   the warm-up, each dev batch through the captured scorer; the second
   epoch captures nothing), every loss and value bit-equal to ``fit_steps``
   over the same shuffled batches from the same state, the dev metrics
   equal to that trainer's ``evaluate``; ms/step (CUDA events around whole
   calls, in turns) of ``fit`` with no batch hooks, with ``TerminateOnNaN``
   (a loss copied to the host each step) and of ``fit_steps`` over the same
   reader's batches, unshuffled and shuffled, beside phase 35's captured
   ms/step and the host's time to gather and pack one shuffled batch; f32:
   ``EarlyStopping(patience=0, restore_best_weights=True)`` with
   ``ModelCheckpoint(None)`` on the dev AUC stops at the first epoch that
   does not improve, and the restored weights score the dev split bit-equal
   to the best epoch's scores; ``load_weights`` after captured steps and
   requests moves no tensor, a captured request then scores as when the file
   was written, and one more captured step equals an eager ``train_step``
   from the same state. Resume, int8 packed and classic (B8): 2 + 1 epochs
   against 2, ``save_checkpoint``, a restore in place into a trainer from
   another seed whose steps are captured already, and 1: every loss, table,
   accumulator, dense parameter and Adam moment bit-equal, the checkpoint's
   size and its save and restore seconds. Checkpoints are written to a
   temporary directory under the process's ``TMPDIR`` and removed;
38. the factorization and sequence zoo (FunkSVD, SVD++, NCF, GRU4Rec,
   SASRec) at ``scripts/din_sparse_ab.py``'s scale (65,536 users, 1,048,576
   items, E=64, batch 4096 of ``[B, 2]`` candidates, positive first;
   histories of 50; GRU hidden 64; SASRec 2 shared layers, dropout 0.2; NCF
   ``layers=(64,)``, dropout 0.2; BPR for the factorization models, BCE for
   the sequence ones), weights from ``init_state(seed)`` with table rows
   N(0, 0.1): all five with f32 packed tables and GRU4Rec, SASRec and SVD++
   (two salted tables a step) with int8 packed item tables, each through
   phase 35's harness (captured ``fit_steps`` at 1 and 4 steps a replay
   against eager ``train_step``s, bit-equal, launches of B2, B3 and B4 from
   zero: the packed tables times the steps); the f32 paths serve ``[1, 500]``
   and ``[128, 500]`` requests from the trained state, captured against
   eager, bit-equal, and SASRec's ``evaluate`` (NDCG@10, Hit@10) over 4
   ``[128, 500]`` batches equals ``MetricList`` of ``predict``; then each
   path's card-against-CPU check of phase 21, its item tables cut to 65,536
   rows and dropout 0 (the two generators draw different masks);
39. the dataset path from files: in a temporary work dir
   (``PYTORCHREC_TPU_WORK_DIR`` under the process's ``TMPDIR``), the port's
   generators write numpy frames, the processing pipeline makes the split,
   negative and history files, and a reader feeds ``fit`` and ``evaluate``.
   DIN at phase 35's width (E=64, attention (80, 40), MLP (200, 80)), f32
   packed, BPR, on ``generate_synthetic_ml`` at MovieLens-1M's shape (6,040
   users, 3,706 items, 20 to 311 ratings a user, about 1.0M rows) through a
   leave-one-out, pair-wise ``HistoryDataReader`` (99 dev and test
   negatives, histories of 20, the native fast sampler): 2 epochs of batch
   4096 with NDCG@10 and Hit@10 on dev, scored in ``[1024, 100]`` batches,
   then test; DCN-v2 at ``bench.py``'s width, f32 packed, BCE, on
   ``generate_synthetic_ctr`` at ``bench.py``'s Criteo shape (13 dense and
   26 sparse fields of 100,000 ids, 1,048,576 rows) through a
   sequential-split, point-wise ``CTRDataReader``: 1 epoch of batch 32768
   with dev AUC and logloss, then test. Each run's launch counts from zero
   across ``fit`` and the test ``evaluate`` (B5 or B1 once a step and once
   a scoring batch, B2 and B4 once a packed table a step), every loss
   finite, ``fit`` bit-equal to ``fit_steps`` over the same batches from
   the same saved state, DIN's test Hit@10 above 0.10 (a random ranking of
   100 candidates) and DCN-v2's dev AUC above 0.5; the generate and
   reader-build seconds (host clock), ``fit`` ms/step (CUDA events; the
   first epochs with their captures and dev scoring, then one more epoch)
   and the test ``evaluate`` ms;
40. the streaming Criteo path (``pytorchrec_tpu_torch/examples/
   criteo_end_to_end.py``, the twin of ``examples/criteo_end_to_end.py``)
   at the example's defaults, in a temporary work dir: ``synth_raw_tsv``
   writes 500,000 raw rows, ``format_criteo`` 4 ``.npz`` shards (3 to
   train on, 1 held out). First a bf16 GEMM's output (``torch.mm(...,
   out_dtype=torch.float32)``) is checked to be f32 and the emulation's
   product within f32 rounding, not bf16's; then two bf16 trainers from one
   state, 8 eager ``train_step``s against ``fit_steps`` at 1 and 4 steps a
   replay over the same streamed batches, every loss and state tensor
   bit-equal; B1, B2 and B4 against their plain versions on the arguments
   of the first eager step (x0 ``[8192, 429]``, the scan's ``[8192*26,
   16]`` gradients at row stride 64, the scatter into ``[2.6M, 64]``).
   Then four runs of the example over the same shards, each with launch
   counts from zero: ``matmul_precision="bfloat16"``, None (f32), and bf16
   with ``--vocab_cap 10000`` and with ``--vocab_cap 700`` (frequency
   vocabs, 16 OOV buckets; the data's 1,000 raw ids a field reach only
   the second cap, whose coverage must stay below 1). Each: DCN-v2 (E=16, 3 cross layers, MLP 256-128, the unified
   ``[2.6M, 64]`` packed f32 table, or the vocabs' rows), 200
   ``fit_steps`` of batch 8192 with a ``StepTimer``, 11 held-out batches
   through ``make_serving_fn``; every batch ``[8192]`` in every column, B1
   launched once a step and once a held-out batch, B2 and B4 once a step,
   every loss finite, the last window's loss below the first's, held-out
   AUC above 0.70, and the bf16 run's AUC within 0.01 of the f32 run's;
   the synth and format seconds, p50 ms/step and examples/s (host clock);
41. DLRM and the sparse trainer's other table formats (``dlrm_phase``):
   DLRM at phase 35's Criteo width (26 fields of 100,000 ids, 13 dense
   columns, E=16, bottom (64,), top (256, 128): 27 field vectors, 351
   interactions, a top input of 367; rows N(0, 0.1)) served through the
   captured scorer at 1, 256 and 4096 rows with the f32 and int8 tables
   (no kernel a request; captured against eager, 256 rows against the
   CPU); then ``phase41_path`` for each training path: one eager step
   whose update kernels' arguments are recorded (``recording_shapes``),
   then 25 captured ``fit_steps`` at batch 32768 with launch counts from
   zero (B2 and B4 once a table a step, B3 or B8 once a step), serving from
   the trained state, and the captured ms/step; DLRM with the packed f32,
   int8 packed and classic int8 tables, and with 26 per-field unpacked
   tables under lazy Adam (``SparseEmbeddingTrainer(model)``, the JAX
   default: a B2 and 3 B4 a table a step), plus one recorded rowwise
   Adagrad step (its ``[V]`` accumulators, B4 on 4-byte rows). Then
   ``scripts/packed_bytes_ab.py``'s seven contenders (DCN-v2, the unified
   ``[2.6M, 16]`` table under f32, byte and bf16 rows, Adam or rowwise
   Adagrad, bf16 at 128 columns; bf16 matmuls, as that script compiles)
   from the same rows over the same batches, timed in 2 interleaved
   rounds of 20 captured steps, bytes/adam against f32/adam bit for bit;
   ``stepped_card_against_cpu`` at batch 512 for DLRM's per-field
   unpacked Adam and for DCN-v2's bf16 rows; every recorded B2, B3, B4 and
   B8 call against its plain version (B2 rtol 1e-5, the others
   bit-exact), B2 and B4 timed, B4 beside its plain version,
   ``index_copy_`` of its kept rows and its plan (``time_scatter``);
42. the normal entry point (``tasks_phase``), in a temporary work dir:
   ``generate_synthetic_ctr`` at bench.py's Criteo shape (1,048,576 rows,
   26 fields of 100,000 ids, 13 dense) with the conversion funnel, split
   sequentially (``warm_n=1``, ``vt_ratio=0.1``); ``console_main.main`` in
   process for DCN-v2 at its full width (E=16, 3 cross layers, MLP
   256-128, batch 32768, 1 epoch, Adam at lr 1e-2, ``auc,logloss``) under
   ``--trainer auto`` (the dense ``Trainer``, 26 per-field tables: B1 once
   a step and once a scoring batch) and ``--trainer sparse`` (the packed
   f32 table: B2 and B4 once a step too); SharedBottom, MMoE, PLE and ESMM
   (the ``esmm`` loss) through ``Task.from_config`` at the JAX defaults
   under the sparse trainer, and MMoE with the int8 packed (B3) and the
   classic (B8) table, ``auc/0,auc/1``; each run's launch counts from zero,
   its ``(best_epoch, dev, test)``, finite losses, AUCs above 0.5 on dev
   and test, its log and model files, and one more epoch timed (CUDA
   events); MMoE card against CPU at batch 512 from a common state
   (``stepped_card_against_cpu``); adagrad, adamw (weight decay 1e-4) and
   Adam with ``grad_clip_norm=1.0`` on DCN-v2's dense parameters, 8 eager
   steps against 4 + 4 captured ones bit for bit (optimizer state too) and
   the card against the CPU from a common state; ``RepeatTask`` (2
   repeats) and ``GridSearch`` (2 lr values) through ``console_main`` on
   a 131,072-row cut, each TSV read back; one ``fit`` under
   ``TorchProfiler``, whose trace must hold CUDA kernels;
43. the serving export (``serving_bundle_phase``): the ops library
   (``csrc/serving_ops.cpp`` with the kernels) and the server
   (``native/serving/aoti_serving.cpp``) built with ``g++`` and ``nvcc``
   beside phase 2; four bundles (``export_serving_bundle``: the
   AOTInductor package, the ops library, the kept inputs and the live
   scorer's scores) from models trained 5 captured steps: DCN-v2 with
   the packed int8 table at 32768 rows (B1's fused form, the in-graph
   dequantize), DCN-v2 f32 under the dense ``Trainer`` at 1 row (B1's rows
   tile), DeepFM f32 packed at 32768 rows (B6's forward) and DIN f32
   packed at ``[1024, 100]`` (B5); the server scores each as a subprocess
   (no Python): exit 0, within the manifest's tolerance, each kernel
   launched 51 times (1 checked + 50 timed runs, one a request); each
   scorer's ``load_serving`` against the live one (rtol 1e-6), one launch;
   the server's median and p90 ms beside the captured ``make_serving_fn``
   request's at the same shape (inputs on the card, and as numpy), the
   package's bytes and the export and compile seconds;
44. B4's sweep (``b4_sweep``, run right after phase 6, from generators of
   its own so that the later phases draw what they drew before): the
   scatter-set against its plain version, bit-exact and one launch a call
   (none at n = 0), at every row width of the main paths and every branch
   of ``scatter_plan`` (``B4_CHECKS``: 4 to 2400-byte rows of f32, u8,
   int8 and bf16; tables at byte offsets 1, 2, 4 and 8, for the 1-, 2-, 4-
   and 8-byte units; unsorted unique ids with negative and too-large ones;
   n = 0, 1 and one past a block); then each main-path width at its
   recorded call's shape (``B4_WIDTHS``: 4- and 16-byte classic rows and
   the 64-byte per-field rows with their unique ids first and the padding
   after, the packed update's 128- to 256-byte rows and DIN's 384-byte and
   1 KB rows with each segment's last slot kept) timed beside its plain
   version, ``index_copy_`` of its kept rows (filtered beforehand,
   untimed), its bytes' bound and its sectors' bound (each 32-byte sector
   that a kept row writes counted whole), with its plan, grid and
   registers;
45. value-based RL (``rl_phase``): DQN at ``scripts/rl_sparse_ab.py``'s
   width (a ``[1048576, 64]`` item table, GRU hidden 64, batch 4096 of
   point-wise rows with 20-step states and 4 next candidates, reward = the
   label, MSE, Adam lr 1e-3, bf16 matmuls, ``update_freq=10``; weights from
   ``--seed``, rows N(0, 0.1)) under ``RLTrainer`` (dense Adam), and
   ``SparseRLTrainer`` with the unpacked table (lazy Adam: B2 and 3 B4 a
   step), the packed f32 rows (B2 and B4 a step) and the int8 ``i_q`` (B2,
   B3 and B4 a step): one recorded eager step, eager ms/step, 21 captured
   ``fit_steps`` (4 a replay; the syncs of steps 10 and 20 inside
   replays) with launch counts from zero, the run's peak memory, the captured
   ms/step over 20 more, and the target sync's own time and share of a
   step; B2, B3 and B4 against their plain versions on the recorded
   arguments (B2 rtol 1e-5, the others bit-exact); the cadence with
   ``update_freq=3`` in captured calls of 1, 3, 1, 3 and 1 steps, bit-equal
   to eager steps after each call and the target equal to the network
   after steps 3, 6 and 9 only; the card against the CPU at 65,536 items
   and batch 512 for the packed f32 and int8 tables; ``console_main`` on
   ``FILES_ML``'s MovieLens-1M shape for ``dqn --trainer sparse`` and
   ``lsrl`` (dense), 100 batch-"epochs" of 4096 with dev NDCG@10 and Hit@10
   every 100, each run's launches from zero;
46. the mesh (``mesh_phase``): a world of one over NCCL (a ``file://``
   store in a temporary dir, a ``(1, 1)`` mesh, the group destroyed at the
   phase's end) at ``bench.py``'s width, DCN-v2 under the dense ``Trainer``
   (B1), the packed f32 rows (B1, B2, B4), the int8 packed rows (B1-B4)
   and the classic int8 table (B1, B2, B4, B8), each run on the mesh and
   without one from the same leaves and batches (device-resident dicts,
   no packed transfer, one step a graph): one eager step (the mesh run's
   kernel arguments recorded), 21 captured ``fit_steps`` with launches from
   zero (the mesh run's equal to the other's), losses and tables held to
   rtol 1e-6, then captured ms/step of each over 20 more (CUDA events); B1,
   B2, B3, B4 and B8 against their plain versions on the recorded
   arguments;
47. the sharded trainer (``sharded_phase``): two ranks sharing ``cuda:0``
   over gloo (NCCL takes one rank a card; processes spawned from this one
   with a launcher's environment, a deadline), a ``(1, 2)`` mesh, over phase
   40's shards: the Criteo twin's command line ``--mesh 1,2`` (26 x 100k
   ids, E=16, batch 8192, 20 eager steps, Adam, bf16 matmuls, packed f32
   tables: B1, B2, B4; its ``rank_device`` starts the group, gloo on
   ``cuda:0``) and ``--mesh 1,2 --hot_mass 0.9 --vocab_cap 50000``
   (hot/cold), the same with B2's plain version in the updates (a witness),
   the model on the grid layout, and DLRM's int8 byte rows as
   ``tests/test_sharded_quantized.py`` builds them (B2, B3, B4); each run's
   launches from zero on each rank (a path kernel with none fails), its
   host-clock ms/step (eager over gloo: a correctness run), its losses and
   merged tables and dense parameters held to its one-process twin on the
   card (rtol 1e-4, the plain-scan pair included; int8 q bytes at most one
   apart; the held-out AUC within 0.01). Hot/cold's fragments put each
   segment of row grads elsewhere in B2's input than one process does, and
   B2's bits follow its tiles: its values that part are held to 4 times the
   parting of one process with B2 against one process with the plain scan
   (``SHARDED_WITNESS_FACTOR``), and its first step's B2 calls are checked
   against plain and against themselves a row and a tile further down
   (``scan_position_witness``). B1 and the update kernels against their
   plain versions on each run's recorded arguments on each rank;
48. two-tower on the mesh (``tt_mesh_phase``): four ranks sharing ``cuda:0``
   over gloo (spawned as phase 47's), a ``(2, 2)`` mesh, the two-tower model
   at phase 24's width (1M users and items, E=64, towers (256, 128),
   cosine / 0.05, packed f32 tables, Adam at 1e-2, the softmax) on
   ``make_tt_cpu_batch``'s rows at batch 4096 (planted duplicate positives,
   logQ, accidental hits masked): one control step with local negatives,
   then 10 eager steps of ``ShardedSparseEmbeddingTrainer`` (1-D) with
   ``global_negatives_axis="data"``, B2 and B4 counted from zero on each
   rank and held to their plain versions on the first step's calls; each
   step's loss within rtol 1e-4 of the one-process ``SparseEmbeddingTrainer``
   on the card (local negatives over the whole batch: the same pool), the
   tables' and dense leaves' values outside rtol 1e-4 / atol 1e-6 within 4
   times (in shares of lr) one process with B2 against one process with
   B2's plain version, the control step's loss apart from it. Then rank 0's
   merged weights in a one-process model on every rank, the bf16
   ``[1M, 128]`` index sharded over ``"model"``, 4096 queries at k=100
   through ``make_sharded_retrieve_fn`` fused (B7 once a call a rank, group
   16) and exact, twice each (host clock): exact ids equal to one process's
   ``make_retrieve_fn`` (scores rtol 1e-5, ids apart only at ties), fused
   recall@100 at least 0.975 with each score the exact score of its id
   (rtol 1e-4 / atol 1e-5); B7 against plain on each rank's shard at 64
   queries;

then a ``two_tower`` JSON line (ms/step,
fused and exact ms a request, recall, index build ms), a ``classic_int8``
line (ms/step of the classic formats, B8's keyed and given-bits times, the
torch hash's, the dedup's and the update's, phase 32's verdict), a
``capture`` line (phase 35's times, busy shares and verdicts by path), a
``capture_requests`` line (phase 36's times, memory and metrics), a ``fit``
line (phase 37's launches, times and checkpoints), a ``zoo`` line (phase
38's ms/step, replay device ms and busy shares, requests, evaluation and
seconds), a ``files`` line (phase 39's seconds, rows, ms/step, scoring ms,
metrics and launches), a ``criteo`` line (phase 40's runs), a ``phase41``
line (its runs' launches and ms/step, the contenders' ranking, the plain
checks), a ``tasks`` line (phase 42's runs: ms/step, dev and test metrics,
launches, seconds; the optimizers, the harnesses and the trace), an ``rl``
line (phase 45's runs, plain checks, cadence and CLI runs), a ``mesh`` line
(phase 46's pairs: ms/step with and without the mesh, the largest
differences, launches), a ``sharded`` line (phase 47's runs: launches by
rank, ms/step, differences from the one-process twin, seconds), a
``tt_mesh`` line (phase 48: losses, lr shares, launches by rank, host-clock
ms, recall, seconds) and a ``{"kernels": [...]}`` line with
every kernel at its main-path shape (``launches``: for B1–B4 the DCN-v2 int8
training run's, for the FM kernels the DeepFM f32 training run's, for the
pooling kernel the DIN f32 training run's, for B7 the two-tower serving
run's, for B8 the DCN-v2 classic training run's; the other paths' counts
beside, the serving ones from captured requests; ``fit_launches``: phase
37's runs; ``zoo_launches``: phase 38's captured runs; ``files_launches``:
phase 39's runs; ``criteo_launches``: phase 40's runs;
``phase41_launches``: phase 41's captured runs; ``phase42_launches``:
phase 42's runs; ``phase43_launches``: phase 43's bundles, the server's
count and the Python process's; B4's ``sweep``: phase 44;
``phase45_launches``: phase 45's runs; ``phase46_launches``: phase 46's
runs, with and without the mesh; ``phase47_launches``: phase 47's runs,
rank 0's and rank 1's; ``phase48_launches``: phase 48's training run and
fused requests, rank by rank), after a ``serving_bundle`` line (phase
43's times, bytes, seconds and launches). Each path
(serving, each training run) zeroes every launch count just before it and
reads them just after.
The last line is ``{"ok": true, "device": {...}}``.
Needs one CUDA card; no JAX and nothing of the JAX package is imported.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import csv
import dataclasses
import datetime
import functools
import gc
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from itertools import islice
from typing import Any, Callable, Optional

import numpy as np
import torch

from pytorchrec_tpu_torch.data import (
    BatchPacker,
    CTRDataReader,
    HistoryDataReader,
    SplitMode,
    TrainMode,
    generate_synthetic_ctr,
    generate_synthetic_ml,
    train_batches,
)
from pytorchrec_tpu_torch import console_main
from pytorchrec_tpu_torch.examples import criteo_end_to_end as criteo_twin
from pytorchrec_tpu_torch.feature_column import CategoricalColumnWithIdentity, NumericColumn
from pytorchrec_tpu_torch.models import (
    DIN,
    DLRM,
    NCF,
    SVDPP,
    DCNv2,
    DeepFM,
    FunkSVD,
    GRU4Rec,
    MMoE,
    SASRec,
    TwoTower,
    ValueRLModel,
)
from pytorchrec_tpu_torch.models import ctr as ctr_module
from pytorchrec_tpu_torch.models.rl import DQNQNet
from pytorchrec_tpu_torch.parallel import DATA_AXIS, MODEL_AXIS, initialize_distributed, make_mesh
from pytorchrec_tpu_torch.ops import attention as attention_module
from pytorchrec_tpu_torch.ops import interactions as interactions_module
from pytorchrec_tpu_torch.ops import quantized_packed as quantized_packed_module
from pytorchrec_tpu_torch.ops import sparse_update as sparse_update_module
from pytorchrec_tpu_torch.ops.embedding import Embedding
from pytorchrec_tpu_torch.ops.precision import bf16_mm
from pytorchrec_tpu_torch.ops.kernels.build import build, serving_ops_library
from pytorchrec_tpu_torch.ops.kernels.cross import (
    FUSED_MAX_WIDTH,
    cross_network,
    cross_network_exact,
    cross_network_plain,
    cross_plan,
    exact_gate,
    tolerance_share,
)
from pytorchrec_tpu_torch.ops.kernels.din_attention import (
    din_attention_pool,
    din_attention_pool_plain,
    tile_plan as din_tile_plan,
)
from pytorchrec_tpu_torch.ops.kernels.fm import (
    fm_interaction,
    fm_interaction_backward,
    fm_interaction_backward_plain,
    fm_interaction_plain,
)
from pytorchrec_tpu_torch.ops.kernels.quantize import (
    id_keyed_rounding_bits,
    quantize_launch_info,
    quantize_rows,
    requantize_launch_info,
    requantize_rows,
    requantize_rows_plain,
    rounding_bits_i32,
    salt_word,
    stochastic_quantize_rows,
    stochastic_quantize_rows_keyed_plain,
    stochastic_quantize_rows_plain,
    table_rounding_salt,
)
from pytorchrec_tpu_torch.ops.kernels.retrieval_topk import (
    DEFAULT_GROUP,
    DEFAULT_TC,
    LANES,
    PAD_SCORE,
    bin_max_scores,
    bin_max_scores_plain,
)
from pytorchrec_tpu_torch.ops.kernels.scatter import (
    scatter_launch_info,
    scatter_plan,
    scatter_set_rows,
    scatter_set_rows_plain,
)
from pytorchrec_tpu_torch.ops.kernels.seg_scan import (
    seg_scan_launch_info,
    segmented_sum_scan,
    segmented_sum_scan_plain,
)
from pytorchrec_tpu_torch.ops.quantized_packed import (
    dequant_packed_rows,
    pack_quantized_table,
    packed_q_base,
    packed_q_width,
    unpack_quantized_table,
)
from pytorchrec_tpu_torch.ops.sparse_update import (
    dedup_row_grads,
    pack_table,
    pack_table_bytes,
    packed_sparse_update,
)
from pytorchrec_tpu_torch.serving import (
    build_item_index,
    export_serving_bundle,
    make_retrieve_fn,
    make_sharded_retrieve_fn,
    shard_item_index,
    shim_binary_path,
)
from pytorchrec_tpu_torch.tasks import Task
from pytorchrec_tpu_torch.serving import retrieval as retrieval_module
from pytorchrec_tpu_torch.training import (
    Callback,
    EarlyStopping,
    ModelCheckpoint,
    QuantizedEmbeddingTrainer,
    RLTrainer,
    ShardedSparseEmbeddingTrainer,
    SparseEmbeddingTrainer,
    SparseRLTrainer,
    TerminateOnNaN,
    Trainer,
)
from pytorchrec_tpu_torch.training import quantized_trainer as quantized_trainer_module
from pytorchrec_tpu_torch.training.quantized_trainer import classic_quantized_update
from pytorchrec_tpu_torch.training.trainer import request_signature
from pytorchrec_tpu_torch.utils import params_from_jax
from pytorchrec_tpu_torch.utils.convert import flax_path, leaves_of
from pytorchrec_tpu_torch.utils.profiling import StepTimer, TorchProfiler
from pytorchrec_tpu_torch.utils.rng import prng_key, split

# bench.py's Criteo-shaped DCN-v2
N_DENSE = 13
N_SPARSE = 26
VOCAB = 100_000
EMB = 16
CROSS_LAYERS = 3
MLP_UNITS = (256, 128)
DIM = N_SPARSE * EMB + N_DENSE  # 429
REQUEST_ROWS = (1, 1000, 4096, 32768)
CANDIDATES = (256, 100)  # [B, N] candidate request
REPEATS = 5  # timed repeats of each request
PROFILED_SHAPES = ((1,), (REQUEST_ROWS[-1],))  # one more request each, under torch.profiler

# training (bench.py): batch, steps timed after warm-up, packed row width
TRAIN_BATCH = 32768
TRAIN_WARMUP, TRAIN_TIMED = 5, 20
PACKED_W = 64  # f32 table || m || v || staging at E=16
Q_W = packed_q_width(EMB, 8, 1)  # 128 bytes: int8 q || scale || acc || staging
Q_BASE = packed_q_base(EMB, 8, 1)  # 24: the int8 rows' staging offset
# the classic (unpacked) quantized tables: format -> (bits, scale column groups)
CLASSIC = {"classic": (8, 1), "classic_int4": (4, 1), "classic_g2": (8, 2)}
# the sparse trainer's table formats (phase 41): name -> SparseEmbeddingTrainer
# arguments; "f32" is the packed f32 rows of every earlier phase, "per_field"
# the default, unpacked tables (DLRM's per-field tables)
SPARSE_FORMATS = {"f32": dict(packed_tables=True), "per_field": {},
                  "bytes": dict(packed_bytes=True),
                  "bf16": dict(packed_tables=True, packed_dtype="bfloat16"),
                  "bf16w128": dict(packed_tables=True, packed_dtype="bfloat16",
                                   packed_min_width=128)}
# DCN-v2's packed leaf, or the classic table's q leaf
TABLES = {**{t: "unified_emb/embedding" for t in SPARSE_FORMATS}, "int8": "unified_q",
          **{t: "unified_q" for t in CLASSIC}}
LIN = "unified_lin/embedding"  # DeepFM's linear table, packed [V, 64] under the f32 trainer
CPU_BATCH, CPU_STEPS = 1024, 2  # card against CPU
LABEL = CategoricalColumnWithIdentity(feature_name="label", category_num=2)
TRAIN_LR = 1e-3

# DeepFM at the same width: 39 field vectors of E=16 (26 sparse, then 13 dense)
FM_FIELDS = N_SPARSE + N_DENSE
DEEP_DIM = FM_FIELDS * EMB  # 624, the deep tower's input
FM_SHAPES = ((1,), (1000,), (TRAIN_BATCH,), (CANDIDATES[0] * CANDIDATES[1],))  # rows

# DIN at the "DIN on Amazon" scale of scripts/din_sparse_ab.py:22-23,45-52
DIN_USERS, DIN_ITEMS = 65_536, 1_048_576
DIN_EMB, DIN_STEPS, DIN_CAND, DIN_BATCH = 64, 20, 2, 4096
DIN_ATT, DIN_MLP = (80, 40), (200, 80)
DIN_PACKED_W = 4 * DIN_EMB  # f32 table || m || v || staging under Adam
DIN_Q_W = packed_q_width(DIN_EMB, 8, 1)  # 384 bytes
DIN_Q_BASE = packed_q_base(DIN_EMB, 8, 1)  # 72: the int8 rows' staging offset
DIN_LOO = 100  # leave-one-out candidates: the positive and neg_sample_n=99
DIN_REQUESTS = ((1,), (1000,), (4096,), (1, DIN_LOO), (256, DIN_LOO), (1024, DIN_LOO))
DIN_CPU_REQUEST = 4  # [256, 100] is also scored on the CPU
DIN_CPU_BATCH = 512
DIN_TABLES = {"f32": "i_embeddings/embedding", "int8": "i_q"}  # the item table's leaf
DIN_TABLE_LR = 2e-2  # DIN's table_lr_hint: the int8 table's rowwise-Adagrad lr
DIN_REQUANTIZE_SEED = 21  # offset of phase 9's generators for DIN's rows
SCAN_EDGES_SEED = 22  # the seed of B2's look-back checks' values (scan_edges)
DIN_ROW_SCALE = 10.0  # table rows N(0, 0.1), ten times the init's (din_leaves says why)

# two-tower retrieval at scripts/retrieval_bench.py:31-57's scale, no cut:
# 1M users and 1M items of E=64, towers (256, 128), D=128, cosine / 0.05
TT_USERS = TT_ITEMS = 1_000_000
TT_EMB, TT_LAYERS, TT_TEMPERATURE = 64, (256, 128), 0.05
TT_DIM = TT_LAYERS[-1]
TT_K = 100
TT_REQUESTS = (1, 256, 4096)  # fused requests of this many queries
TT_CPU_REQUEST = 256  # also served on the CPU
TT_INDEX_BATCH = 131072
TT_BATCH, TT_LR = 4096, 1e-2  # training (tests/test_two_tower.py:377's lr)
TT_CPU_BATCH = 512
TT_PACKED_W = 4 * TT_EMB  # f32 table || m || v || staging under Adam
TT_Q_W = packed_q_width(TT_EMB, 8, 1)  # 384 bytes
TT_TABLES = {"f32": "i_embeddings/embedding", "int8": "i_q"}  # the item table's leaf
TT_ROW_SCALE = 10.0  # table rows N(0, 0.1), as DIN's (tt_leaves says why)
TT_RECALL_MIN = 0.975
# B7 at the serving shape: 4096 queries x 1M items, D=128, tc 2048, group 16
B7_QUERIES = 4096
# DCN-v2 at scripts/int8_e64_ab.py:21,54-55's E=64: the cross network's D is
# 26 * 64 + 13 = 1677, past the fused form's width
E64 = 64
E64_DIM = N_SPARSE * E64 + N_DENSE
E64_REQUEST_ROWS = (1, 4096, 32768)
# phase 3: widths past the fused form's at these batches
WIDE_DIMS = (513, 1677, 2048)
WIDE_ROWS = (1, 1000, 4097, 32768)
# phase 3's grid against cuBLAS
SWEEP_ROWS = (9, 33, 129, 256, 512, 1000, 1536, 2000, 4097)
SWEEP_DIMS = (64, 256, 429, 512, 513, 700, 1024, 1677, 2048)
# Adam (optim/optimizers.py, ops/sparse_update.py): beta1, beta2, and the RMS
# gradient under which a step's size hangs on a gradient's last bits (100 eps)
ADAM_BETA1, ADAM_BETA2 = 0.9, 0.999
ADAM_EPS_WINDOW = 1e-6
# the dense moments, card against CPU after a step from a common state, each
# as a multiple of the step's gradient g: exp_avg (which takes (1 - beta1) g)
# and the square root of exp_avg_sq (which takes (1 - beta2) g^2), rtol 1e-4
# and atols that hold g to 1e-7, a tenth of the eps window (the card's and the
# CPU's sums of a gradient over the batch differ by up to 3.3e-8 in the
# two-tower model, 9.3e-10 in DIN: H100 80GB HBM3, 700 W)
GRAD_ATOL = 1e-7
MOMENT_CHECKS = {"exp_avg": (lambda m: m, (1 - ADAM_BETA1) * GRAD_ATOL),
                 "exp_avg_sq": (torch.sqrt, (1 - ADAM_BETA2) ** 0.5 * GRAD_ATOL),
                 # adagrad's accumulator (phase 42): sqrt(0.1 + sum of g^2)
                 "sum": (torch.sqrt, GRAD_ATOL)}

ALL_KERNELS = (cross_network, segmented_sum_scan, requantize_rows, scatter_set_rows,
               fm_interaction, fm_interaction_backward, din_attention_pool, bin_max_scores,
               stochastic_quantize_rows)

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, bf16 on
# the tensor cores (dense), HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12

# kernel against plain: f32 sums of D terms run in another order
RTOL, ATOL = 1e-4, 1e-6
# device clock cycles of spin queued ahead of each timed call (about 1 ms)
HEADSTART_CYCLES = 2_000_000
# the FM forward: within 1e-5 of its terms' magnitude (a difference of two
# positive sums, each summed in another order); its backward rtol 1e-5
FM_RTOL, FM_ATOL = 1e-5, 1e-7


def counts() -> dict:
    """Every kernel wrapper's launch count."""
    return {k: k.launches for k in ALL_KERNELS}


def zero_counts() -> None:
    for kernel in ALL_KERNELS:
        kernel.launches = 0


def check_launches(label: str, before: dict, want: dict) -> None:
    """Raises unless each kernel launched ``want[kernel]`` times (0 where
    absent) since ``before``."""
    got = {k: k.launches - before[k] for k in ALL_KERNELS}
    expected = {k: want.get(k, 0) for k in ALL_KERNELS}
    if got != expected:
        raise AssertionError(f"{label}: launches {names(got)}, want {names(expected)}")


def names(launches: dict) -> dict:
    return {k.__name__: n for k, n in launches.items()}


def close(got: torch.Tensor, want: torch.Tensor, rtol: float = RTOL, atol: float = ATOL) -> float:
    """Max abs error; raises if any element is outside atol + rtol*|want|."""
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any() or not torch.isfinite(got).all():
        raise AssertionError(f"mismatch: {int(bad.sum())} of {got.numel()} elements outside "
                             f"rtol={rtol} atol={atol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cross_inputs(rng: np.random.Generator, batch: int, dim: int, device):
    """x0 laid out as on the serving path: embeddings ~ N(0, 0.01) then
    N_DENSE dense values ~ N(0, 1); weights as initialised, N(0, 0.01)."""
    x0 = rng.normal(0.0, 0.01, (batch, dim)).astype(np.float32)
    x0[:, -min(N_DENSE, dim):] = rng.normal(size=(batch, min(N_DENSE, dim)))
    ws = rng.normal(0.0, 0.01, (CROSS_LAYERS, dim, dim)).astype(np.float32)
    bs = rng.normal(0.0, 0.01, (CROSS_LAYERS, dim)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x0, ws, bs)]


def plan_name(batch: int, dim: int) -> str:
    """The form (and tile and k-slices) the wrapper's plan runs at a shape."""
    plan = cross_plan(batch, dim, torch.cuda.get_device_properties(0)
                      .multi_processor_count)
    if plan.form == "fused":
        return "fused"
    return f"tiled, tile {plan.tile}, {plan.splits} k-slice{'s' * (plan.splits > 1)}"


def check_cross(rng: np.random.Generator) -> float:
    """Phase 3: kernel against plain at every shape serving gives it, an odd
    width, the widths past the fused form's and a batch of a few rows;
    past D = 512 against the exact sums (``exact_gate``). Returns the max
    abs error at D=429."""
    worst = 0.0
    shapes = [(b, DIM) for b in (*REQUEST_ROWS, CANDIDATES[0] * CANDIDATES[1])] + [(1000, 37)]
    shapes += [(b, d) for d in WIDE_DIMS for b in WIDE_ROWS] + [(5, DIM), (5, E64_DIM)]
    for batch, dim in shapes:
        x0, ws, bs = cross_inputs(rng, batch, dim, "cuda")
        got = cross_network(x0, ws, bs)
        want = cross_network_plain(x0, ws, bs)
        torch.cuda.synchronize()
        label = f"B={batch:6d} D={dim} L={CROSS_LAYERS} ({plan_name(batch, dim)})"
        if dim <= FUSED_MAX_WIDTH:
            err = close(got, want)
            print(f"cross_network kernel vs plain  {label}: max abs err {err:.3e}")
        else:
            gate = exact_gate(got, want, cross_network_exact(x0, ws, bs))
            print(f"cross_network kernel vs exact sums  {label}: kernel {gate['kernel']:.3f}, "
                  f"cuBLAS {gate['cublas']:.3f} x the tolerance; max abs err against plain "
                  f"{float((got - want).abs().max()):.3e}")
            if not gate["ok"]:
                raise AssertionError(f"cross_network {label}: farther from the exact sums than "
                                     f"the tolerance and than cuBLAS")
        if dim == DIM:
            worst = max(worst, err)
    return worst


def normal_leaf(rng: np.random.Generator, *shape) -> np.ndarray:
    """N(0, 0.01) f32, as the JAX package initialises every weight."""
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.01)


def packed_f32_leaf(rows: np.ndarray, width: int) -> np.ndarray:
    """``[V, width]`` packed ``table || m || v || pad`` rows of
    ``SparseEmbeddingTrainer(packed_tables=True)``, moments zero."""
    packed = np.zeros((rows.shape[0], width), np.float32)
    packed[:, :rows.shape[1]] = rows
    return packed


def packed_q_leaf(rows: np.ndarray, width: int) -> np.ndarray:
    """``[V, width]`` u8 ``q || scale || acc || pad`` rows of
    ``QuantizedEmbeddingTrainer(packed_tables=True)``: int8, one scale a row
    (round to nearest), accumulator zero."""
    emb = rows.shape[1]
    absmax = np.abs(rows).max(axis=1)
    scale = np.where(absmax > 0, absmax / np.float32(127.0), np.float32(1.0)).astype(np.float32)
    q = np.clip(np.rint(rows / scale[:, None]), -127, 127).astype(np.int8)
    packed = np.zeros((rows.shape[0], width), np.uint8)
    packed[:, :emb] = q.view(np.uint8)
    packed[:, emb:emb + 4] = scale[:, None].view(np.uint8)
    return packed


def classic_q_leaves(rows: np.ndarray, bits: int = 8, groups: int = 1) -> dict:
    """The classic leaves of ``QuantizedEmbeddingTrainer()`` (one draw,
    round to nearest): ``unified_q`` int8 ``[V, E]`` (int4: ``[V, E/2]``,
    even columns in the low nibble) and ``unified_scale`` f32 ``[V]`` (``[V,
    G]`` with G column groups)."""
    n, emb = rows.shape
    qmax = np.float32(127.0 if bits == 8 else 7.0)
    grouped = rows.reshape(n, groups, emb // groups)
    absmax = np.abs(grouped).max(axis=2)
    scale = np.where(absmax > 0, absmax / qmax, np.float32(1.0)).astype(np.float32)
    q = np.clip(np.rint(grouped / scale[..., None]), -qmax, qmax).astype(np.int32).reshape(n, emb)
    if bits == 4:
        q = (q[:, 0::2] & 0xF) | ((q[:, 1::2] & 0xF) << 4)
    return {"unified_q": q.astype(np.uint8).view(np.int8),
            "unified_scale": scale[:, 0] if groups == 1 else scale}


def table_leaves(rng: np.random.Generator, table: str, emb: int = EMB) -> dict:
    """The unified field table's leaves: f32, the ``[V, 4E]`` packed f32 rows
    (``[V, 64]`` at E=16); int8, the packed u8 rows (``[V, 128]`` at E=16); a
    classic format, ``unified_q`` and ``unified_scale``."""
    rows = normal_leaf(rng, N_SPARSE * VOCAB, emb)
    if table == "f32":
        return {"unified_emb/embedding": packed_f32_leaf(rows, 4 * emb)}
    if table == "int8":
        return {"unified_q": packed_q_leaf(rows, packed_q_width(emb, 8, 1))}
    return classic_q_leaves(rows, *CLASSIC[table])


def flax_leaves(rng: np.random.Generator, table: str, emb: int = EMB) -> dict:
    """Random DCN-v2 parameters in the flax leaf layout (``/``-joined paths),
    N(0, 0.01) as the JAX package initialises them, at embedding width
    ``emb``."""
    dim = N_SPARSE * emb + N_DENSE
    leaves = {
        "cross/ws": normal_leaf(rng, CROSS_LAYERS, dim, dim),
        "cross/bs": normal_leaf(rng, CROSS_LAYERS, dim),
        "deep/Dense_0/Dense_0/kernel": normal_leaf(rng, dim, MLP_UNITS[0]),
        "deep/Dense_0/Dense_0/bias": normal_leaf(rng, MLP_UNITS[0]),
        "deep/Dense_1/Dense_0/kernel": normal_leaf(rng, MLP_UNITS[0], MLP_UNITS[1]),
        "deep/Dense_1/Dense_0/bias": normal_leaf(rng, MLP_UNITS[1]),
        "head/kernel": normal_leaf(rng, dim + MLP_UNITS[1], 1),
        "head/bias": normal_leaf(rng, 1),
        # created by every DCN-v2 tree, never read; the converter drops them
        "bias": np.zeros((), np.float32),
        "dense_factors": normal_leaf(rng, N_DENSE, emb),
        "dense_linear": normal_leaf(rng, N_DENSE),
    }
    leaves.update(table_leaves(rng, table, emb))
    return leaves


def deepfm_leaves(rng: np.random.Generator, table: str) -> dict:
    """Random DeepFM parameters in the flax leaf layout. The linear table is
    the f32 trainer's packed ``[V, 64]`` leaf (``packed_width(1, "adam")``:
    4 columns used) beside f32 field rows, and a plain ``[V, 1]`` leaf beside
    int8 rows (the quantized trainer keeps it in the dense optimizer)."""
    leaves = {
        "deep/Dense_0/Dense_0/kernel": normal_leaf(rng, DEEP_DIM, MLP_UNITS[0]),
        "deep/Dense_0/Dense_0/bias": normal_leaf(rng, MLP_UNITS[0]),
        "deep/Dense_1/Dense_0/kernel": normal_leaf(rng, MLP_UNITS[0], MLP_UNITS[1]),
        "deep/Dense_1/Dense_0/bias": normal_leaf(rng, MLP_UNITS[1]),
        "deep_head/kernel": normal_leaf(rng, MLP_UNITS[1], 1),
        "bias": np.zeros((), np.float32),
        "dense_factors": normal_leaf(rng, N_DENSE, EMB),
        "dense_linear": normal_leaf(rng, N_DENSE),
    }
    lin = normal_leaf(rng, N_SPARSE * VOCAB, 1)
    if table == "f32":
        packed = np.zeros((lin.shape[0], PACKED_W), np.float32)
        packed[:, :1] = lin
        lin = packed
    leaves[LIN] = lin
    leaves.update(table_leaves(rng, table))
    return leaves


def din_leaves(rng: np.random.Generator, table: str) -> dict:
    """Random DIN parameters in the flax leaf layout: the attention's
    ``w<i>``/``b<i>`` ``[in, out]``, the MLP and the bias-free head N(0, 0.01);
    f32 tables as the packed ``[V, 256]`` leaves of the sparse trainer, or
    the int8 item table as the ``[V, 384]`` u8 ``i_q`` beside a plain f32
    user table.

    The table rows are N(0, 0.1), not the init's N(0, 0.01). At N(0, 0.01) the
    MLP's biases outweigh the item's share of its inputs, so the two
    candidates of a ``[B, 2]`` row look alike to it and the BCE pair's
    gradients (-1/2 and +1/2 a row) cancel to near Adam's eps. There
    ``g / (|g| + eps)`` turns the card's and the CPU's last-bit differences
    into a visible share of a step: 2.6e-6 in an MLP bias after 2 steps on
    the H100, over phase 21's tolerance. Rows ten times larger set the
    candidates apart and the pair's gradients no longer cancel."""
    dims = [4 * DIN_EMB, *DIN_ATT, 1]
    leaves = {}
    for i in range(len(dims) - 1):
        leaves[f"attention/w{i}"] = normal_leaf(rng, dims[i], dims[i + 1])
        leaves[f"attention/b{i}"] = normal_leaf(rng, dims[i + 1])
    width = 4 * DIN_EMB
    for i, units in enumerate(DIN_MLP):
        leaves[f"mlp/Dense_{i}/Dense_0/kernel"] = normal_leaf(rng, width, units)
        leaves[f"mlp/Dense_{i}/Dense_0/bias"] = normal_leaf(rng, units)
        width = units
    leaves["head/kernel"] = normal_leaf(rng, width, 1)
    users = normal_leaf(rng, DIN_USERS, DIN_EMB) * np.float32(DIN_ROW_SCALE)
    items = normal_leaf(rng, DIN_ITEMS, DIN_EMB) * np.float32(DIN_ROW_SCALE)
    if table == "f32":
        leaves["u_embeddings/embedding"] = packed_f32_leaf(users, DIN_PACKED_W)
        leaves["i_embeddings/embedding"] = packed_f32_leaf(items, DIN_PACKED_W)
    else:
        leaves["u_embeddings/embedding"] = users
        leaves["i_q"] = packed_q_leaf(items, DIN_Q_W)
    return leaves


def make_din(table: str, device, seed: int) -> DIN:
    """DIN at ``scripts/din_sparse_ab.py``'s scale, with the f32 or the int8
    item table."""
    col = CategoricalColumnWithIdentity
    return DIN(uid_column=col(feature_name="uid", category_num=DIN_USERS),
               iid_column=col(feature_name="iid", category_num=DIN_ITEMS),
               his_column=col(feature_name="pos_his", category_num=DIN_ITEMS),
               his_len_column=col(feature_name="pos_his_len", category_num=DIN_STEPS + 1),
               label_column=LABEL, emb_size=DIN_EMB, att_hidden_units=DIN_ATT,
               mlp_layers=DIN_MLP, quantized_table=table == "int8", device=device,
               generator=torch.Generator(device=device).manual_seed(seed))


def make_ctr(cls, table: str, device, seed: int, emb: int = EMB):
    """DCN-v2 or DeepFM (``cls``) at ``bench.py``'s Criteo width (embedding
    width ``emb``), with the unified table of ``table`` (f32, packed int8 or
    a classic format)."""
    sparse = [CategoricalColumnWithIdentity(feature_name=f"c_{i}", category_num=VOCAB)
              for i in range(N_SPARSE)]
    dense = [NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)]
    bits, groups = CLASSIC.get(table, (8, 1))
    kwargs = dict(sparse_columns=sparse, dense_columns=dense, label_column=LABEL, emb_size=emb,
                  layers=MLP_UNITS, unified_embedding=True,
                  quantized_embedding=table not in SPARSE_FORMATS,
                  table_packed=table == "int8", table_bits=bits, scale_col_groups=groups,
                  device=device, generator=torch.Generator(device=device).manual_seed(seed))
    if cls is DCNv2:
        kwargs["num_cross_layers"] = CROSS_LAYERS
    return cls(**kwargs)


def make_train_batch(rng: np.random.Generator, rows: int = TRAIN_BATCH) -> dict:
    """``bench.py``'s ``make_host_batch`` at ``rows`` rows."""
    batch = {f"c_{i}": rng.integers(0, VOCAB, size=rows).astype(np.int32)
             for i in range(N_SPARSE)}
    for i in range(N_DENSE):
        batch[f"d_{i}"] = rng.normal(size=rows).astype(np.float32)
    batch["label"] = rng.integers(0, 2, size=rows).astype(np.int32)
    return batch


def unified_ids(fields: dict) -> np.ndarray:
    """Ids in the unified table, row after row, as the trainer flattens them."""
    return np.stack([fields[f"c_{i}"].astype(np.int64) + i * VOCAB for i in range(N_SPARSE)],
                    axis=1).reshape(-1)


def make_requests(rng: np.random.Generator, request_rows=REQUEST_ROWS,
                  candidates: bool = True) -> list:
    """Host (numpy) requests as a server receives them; no label column."""
    requests = []
    for rows in request_rows:
        req = {f"c_{i}": rng.integers(0, VOCAB, rows).astype(np.int32) for i in range(N_SPARSE)}
        req.update({f"d_{i}": rng.normal(size=rows).astype(np.float32) for i in range(N_DENSE)})
        requests.append((f"{rows} rows", req, (rows,)))
    if not candidates:
        return requests
    b, n = CANDIDATES
    # item-side fields per candidate [B, N]; user-side fields [B], broadcast
    req = {f"c_{i}": rng.integers(0, VOCAB, (b, n) if i < N_SPARSE // 2 else b).astype(np.int32)
           for i in range(N_SPARSE)}
    req.update({f"d_{i}": rng.normal(size=b).astype(np.float32) for i in range(N_DENSE)})
    requests.append((f"candidates {b}x{n}", req, (b, n)))
    return requests


def make_din_batch(rng: np.random.Generator, rows: int = DIN_BATCH) -> dict:
    """``scripts/din_sparse_ab.py``'s ``make_host_batch`` at ``rows`` rows: 2
    candidates (positive first), 20 history steps of ids in [1, V), all
    valid."""
    return {
        "uid": rng.integers(0, DIN_USERS, size=rows).astype(np.int32),
        "iid": rng.integers(0, DIN_ITEMS, size=(rows, DIN_CAND)).astype(np.int32),
        "pos_his": rng.integers(1, DIN_ITEMS, size=(rows, DIN_STEPS)).astype(np.int32),
        "pos_his_len": rng.integers(1, DIN_STEPS + 1, size=rows).astype(np.int32),
        "label": rng.integers(0, 2, size=rows).astype(np.int32),
    }


def make_din_requests(rng: np.random.Generator) -> list:
    """DIN requests (no label): point-wise rows and candidate requests
    ``[B, 100]``; histories of ``pos_his_len`` ids, then PAD (0), as the
    history reader lays them out."""
    requests = []
    for shape in DIN_REQUESTS:
        req = make_din_batch(rng, shape[0])
        del req["label"]
        steps = np.arange(DIN_STEPS)[None, :]
        req["pos_his"][steps >= req["pos_his_len"][:, None]] = 0
        req["iid"] = rng.integers(0, DIN_ITEMS, size=shape).astype(np.int32)
        name = f"{shape[0]} rows" if len(shape) == 1 else f"candidates {shape[0]}x{shape[1]}"
        requests.append((name, req, shape))
    return requests


def din_item_ids(batch: dict) -> np.ndarray:
    """The item table's ids of a batch in the trainer's order: candidates,
    then history."""
    iid = batch["iid"].reshape(batch["iid"].shape[0], -1)
    return np.concatenate([iid.reshape(-1), batch["pos_his"].reshape(-1)]).astype(np.int64)


def din_table_ids(path: str, batch: dict) -> np.ndarray:
    """The ids a DIN batch gathers from the packed table at ``path``."""
    return batch["uid"].astype(np.int64) if path.startswith("u_") else din_item_ids(batch)


class PlainCross(torch.nn.Module):
    """The model's cross network with the plain version in place of the
    kernel (same parameters), for the reference scores."""

    def __init__(self, cross):
        super().__init__()
        self.inner = cross

    def forward(self, x0):
        flat = x0.reshape(-1, self.inner.dim)
        return cross_network_plain(flat, self.inner.ws, self.inner.bs).reshape(x0.shape)


def plain_fm(field_vectors: torch.Tensor) -> torch.Tensor:
    """The models' ``fm_interaction`` with the plain version in place of the
    kernel, for the reference scores."""
    lead = field_vectors.shape[:-2]
    return fm_interaction_plain(field_vectors.reshape(-1, FM_FIELDS, EMB)).reshape(lead)


@contextlib.contextmanager
def swapped(owner, name: str, plain):
    """Inside: ``owner.name`` is ``plain``, the plain version in place of a
    model's forward kernel (the same parameters and inputs)."""
    kernel = getattr(owner, name)
    setattr(owner, name, plain)
    try:
        yield
    finally:
        setattr(owner, name, kernel)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """What the serving, training and card-against-CPU phases need to know
    of one model at its scale here."""
    name: str
    make: Callable  # (table, device, seed) -> the model, with the f32 or int8 table
    leaves: Callable  # (rng, table) -> random parameters in the flax leaf layout
    batch: Callable  # (rng, rows) -> a host training batch
    table_ids: Callable  # (packed table path, host batch) -> the ids it gathers
    tables: dict  # table format -> the largest table's leaf (int8: the packed u8 buffer)
    q_name: str  # the quantized table's name in unpacked_quantized()
    forward_kernel: Any  # one launch a scored request (None: the model's scoring runs none)
    plain_forward: Optional[Callable]  # (model) -> a context in which it runs the plain version
    per_step: dict  # table format -> {kernel: launches a train step}; the others none
    train_rows: int
    cpu_rows: int  # batch of the card against the CPU
    cpu_request: int  # index of the serving request also scored on the CPU
    emb: int
    scored_key: str  # the batch field whose shape the scores take
    table_lr: Optional[float] = None  # the int8 table's lr, where the model sets it
    loss: str = "bce"
    lr: float = TRAIN_LR
    after_train: Optional[Callable] = None  # (trainer, host batches, tag): more of the path
    trainer: Optional[Callable] = None  # (model, table, device) -> its trainer, where not the
    # sparse or quantized trainer that the table format names


DCNV2_SPEC = ModelSpec(
    name="dcnv2", make=functools.partial(make_ctr, DCNv2), leaves=flax_leaves,
    batch=make_train_batch, table_ids=lambda path, batch: unified_ids(batch), tables=TABLES,
    q_name="unified", forward_kernel=cross_network,
    plain_forward=lambda model: swapped(model, "cross", PlainCross(model.cross)),
    per_step={"f32": {cross_network: 1, segmented_sum_scan: 1, scatter_set_rows: 1},
              "int8": {cross_network: 1, segmented_sum_scan: 1, requantize_rows: 1,
                       scatter_set_rows: 1},
              # the classic step: the dedup's scan, B8 (int8, one scale a row), and
              # the scatter-set of q and of scale
              "classic": {cross_network: 1, segmented_sum_scan: 1, stochastic_quantize_rows: 1,
                          scatter_set_rows: 2},
              **{t: {cross_network: 1, segmented_sum_scan: 1, scatter_set_rows: 2}
                 for t in ("classic_int4", "classic_g2")}},
    train_rows=TRAIN_BATCH, cpu_rows=CPU_BATCH, cpu_request=1, emb=EMB, scored_key="c_0")
DEEPFM_SPEC = dataclasses.replace(
    DCNV2_SPEC, name="deepfm", make=functools.partial(make_ctr, DeepFM), leaves=deepfm_leaves,
    forward_kernel=fm_interaction,
    plain_forward=lambda model: swapped(ctr_module, "fm_interaction", plain_fm),
    per_step={"f32": {fm_interaction: 1, fm_interaction_backward: 1, segmented_sum_scan: 2,
                      scatter_set_rows: 2},
              "int8": {fm_interaction: 1, fm_interaction_backward: 1, segmented_sum_scan: 1,
                       requantize_rows: 1, scatter_set_rows: 1},
              "classic": {fm_interaction: 1, fm_interaction_backward: 1, segmented_sum_scan: 1,
                          stochastic_quantize_rows: 1, scatter_set_rows: 2}})
DIN_SPEC = ModelSpec(
    name="din", make=make_din, leaves=din_leaves, batch=make_din_batch, table_ids=din_table_ids,
    tables=DIN_TABLES, q_name="i", forward_kernel=din_attention_pool,
    plain_forward=lambda model: swapped(attention_module, "din_attention_pool",
                                        din_attention_pool_plain),
    per_step={"f32": {din_attention_pool: 1, segmented_sum_scan: 2, scatter_set_rows: 2},
              "int8": {din_attention_pool: 1, segmented_sum_scan: 1, requantize_rows: 1,
                       scatter_set_rows: 1}},
    train_rows=DIN_BATCH, cpu_rows=DIN_CPU_BATCH, cpu_request=DIN_CPU_REQUEST, emb=DIN_EMB,
    scored_key="iid", table_lr=DIN_TABLE_LR)


# DCN-v2 at scripts/int8_e64_ab.py's E=64: D = 1677, past the fused form's
# width, so every request and step runs B1's tiled form
E64_SPEC = dataclasses.replace(
    DCNV2_SPEC, name="dcnv2_e64", make=functools.partial(make_ctr, DCNv2, emb=E64),
    leaves=functools.partial(flax_leaves, emb=E64),
    per_step={t: DCNV2_SPEC.per_step[t] for t in ("f32", "int8")}, emb=E64)


def he_leaf(rng: np.random.Generator, fan_in: int, fan_out: int) -> np.ndarray:
    """A ``[fan_in, fan_out]`` kernel N(0, 2 / fan_in)."""
    return rng.standard_normal((fan_in, fan_out), dtype=np.float32) * np.float32(
        np.sqrt(2.0 / fan_in))


def tt_leaves(rng: np.random.Generator, table: str) -> dict:
    """Random two-tower parameters in the flax leaf layout: each tower's MLP
    and projection kernels N(0, 2 / fan_in), biases N(0, 0.01); the f32
    tables as the packed ``[V, 256]`` leaves of the sparse trainer, or the int8
    item table as the ``[V, 384]`` u8 ``i_q`` beside a plain f32 user table.

    Not the init's N(0, 0.01) everywhere: through three layers of 0.01
    weights every tower output is about its biases, so every item scores
    alike (retrieval would rank ties, and a bf16 index would merge them), and
    the in-batch softmax's gradients cancel to near Adam's eps, where the
    card's and the CPU's last-bit differences become a visible share of a
    step (tests/test_two_tower.py calls it the plateau). Table rows are
    N(0, 0.1), as DIN's."""
    leaves = {}
    for tower in ("user", "item"):
        fan_in = TT_EMB
        for i, units in enumerate(TT_LAYERS):
            leaves[f"{tower}_mlp/Dense_{i}/Dense_0/kernel"] = he_leaf(rng, fan_in, units)
            leaves[f"{tower}_mlp/Dense_{i}/Dense_0/bias"] = normal_leaf(rng, units)
            fan_in = units
        leaves[f"{tower}_proj/kernel"] = he_leaf(rng, fan_in, TT_DIM)
        leaves[f"{tower}_proj/bias"] = normal_leaf(rng, TT_DIM)
    users = normal_leaf(rng, TT_USERS, TT_EMB) * np.float32(TT_ROW_SCALE)
    items = normal_leaf(rng, TT_ITEMS, TT_EMB) * np.float32(TT_ROW_SCALE)
    if table == "f32":
        leaves["u_embeddings/embedding"] = packed_f32_leaf(users, TT_PACKED_W)
        leaves["i_embeddings/embedding"] = packed_f32_leaf(items, TT_PACKED_W)
    else:
        leaves["u_embeddings/embedding"] = users
        leaves["i_q"] = packed_q_leaf(items, TT_Q_W)
    return leaves


def make_two_tower(table: str, device, seed: int, mask: bool = False,
                   global_negatives_axis: Optional[str] = None) -> TwoTower:
    """The two-tower model at ``scripts/retrieval_bench.py``'s scale, with
    the f32 or the int8 item table (and cross-replica negatives over
    ``global_negatives_axis`` on a mesh, phase 48)."""
    col = CategoricalColumnWithIdentity
    return TwoTower(uid_column=col(feature_name="uid", category_num=TT_USERS),
                    iid_column=col(feature_name="iid", category_num=TT_ITEMS),
                    emb_size=TT_EMB, layers=TT_LAYERS, normalize=True,
                    temperature=TT_TEMPERATURE, mask_accidental_hits=mask,
                    global_negatives_axis=global_negatives_axis,
                    quantized_table=table == "int8", device=device,
                    generator=torch.Generator(device=device).manual_seed(seed))


def make_tt_batch(rng: np.random.Generator, rows: int = TT_BATCH) -> dict:
    """In-batch-negatives training rows: ``uid [B]`` and the positive
    ``iid [B, 1]``, ids uniform over the tables."""
    return {"uid": rng.integers(0, TT_USERS, size=rows).astype(np.int32),
            "iid": rng.integers(0, TT_ITEMS, size=(rows, 1)).astype(np.int32)}


def make_tt_cpu_batch(rng: np.random.Generator, rows: int = TT_CPU_BATCH) -> dict:
    """``make_tt_batch`` with planted duplicate positives (8 groups of 4
    rows share an item: accidental hits to mask) and a raw sampling
    probability a row under ``TwoTower.Q_KEY`` (float64, as numpy makes
    it)."""
    batch = make_tt_batch(rng, rows)
    for group in range(8):
        batch["iid"][16 * group:16 * group + 4, 0] = batch["iid"][16 * group, 0]
    batch[TwoTower.Q_KEY] = rng.uniform(1e-6, 1e-3, size=rows)
    return batch


def tt_table_ids(path: str, batch: dict) -> np.ndarray:
    """The ids a two-tower batch gathers from the packed table at ``path``."""
    return (batch["uid"] if path.startswith("u_") else batch["iid"].reshape(-1)).astype(np.int64)


def tt_retrieve_trained(trainer, host: list, tag: str) -> None:
    """Phases 24 and 25, the serving end of training: the trained model's
    item index rebuilt, then one fused retrieval of 256 users, which
    launches B7 once."""
    index = build_item_index(trainer.model, TT_ITEMS, batch_size=TT_INDEX_BATCH)
    before = counts()
    scores, ids = make_retrieve_fn(trainer.model, approx="fused")(index, host[1]["uid"][:256],
                                                                  TT_K)
    torch.cuda.synchronize()
    check_launches(f"{tag} fused retrieval from the trained state", before, {bin_max_scores: 1})
    if tuple(ids.shape) != (256, TT_K) or not torch.isfinite(scores).all() or (
            ids.min() < 0 or ids.max() >= TT_ITEMS):
        raise AssertionError(f"{tag} fused retrieval from the trained state failed")
    print(f"{tag} fused retrieval from the rebuilt index: 256 x {TT_K}, top score mean "
          f"{float(scores[:, 0].mean()):.4f}")


TT_SPEC = ModelSpec(
    name="two_tower", make=make_two_tower, leaves=tt_leaves, batch=make_tt_batch,
    table_ids=tt_table_ids, tables=TT_TABLES, q_name="i", forward_kernel=None,
    plain_forward=None,
    per_step={"f32": {segmented_sum_scan: 2, scatter_set_rows: 2},
              "int8": {segmented_sum_scan: 1, requantize_rows: 1, scatter_set_rows: 1}},
    train_rows=TT_BATCH, cpu_rows=TT_CPU_BATCH, cpu_request=None, emb=TT_EMB, scored_key="iid",
    table_lr=TT_LR, loss="softmax", lr=TT_LR, after_train=tt_retrieve_trained)
# the card against the CPU: accidental hits masked, duplicates planted, logQ
TT_CPU_SPEC = dataclasses.replace(TT_SPEC, make=functools.partial(make_two_tower, mask=True),
                                  batch=make_tt_cpu_batch)


def profile_call(fn, label: str, launches=None, top: int = 6, host_top: int = 0):
    """Where one call's time goes: torch.profiler's device time by kernel or
    copy, against the call's host-clocked wall time, and (``host_top``) the
    host operators with the most self time. The call must launch each kernel
    as often as ``launches`` says (default: the cross kernel once) and no
    other. Returns (wall ms, device busy ms or None where none was
    recorded)."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    before = counts()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    check_launches(f"{label}: profiled call", before,
                   {cross_network: 1} if launches is None else launches)
    # the device's own events (kernels, copies); CPU ops repeat their kernels' time
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        print(f"{label} profile: no device time recorded (not measured); wall {wall_ms:.3f} ms")
        return wall_ms, None
    print(f"{label} profile: wall {wall_ms:.3f} ms, device busy {device_ms:.3f} ms "
          f"({100 * device_ms / wall_ms:.1f}%)")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    for e in ranked[:top]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<3d} {e.key[:90]}")
    if ranked[top:]:
        rest = ranked[top:]
        print(f"    {sum(e.self_device_time_total for e in rest) / 1e3:8.3f} ms  "
              f"x{sum(e.count for e in rest):<3d} the {len(rest)} other kinds")
    if host_top:
        host = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU]
        host_ms = sum(e.self_cpu_time_total for e in host) / 1e3
        print(f"{label} host: {host_ms:.3f} ms of operator self time (profiler on), "
              f"{sum(e.count for e in host)} operator calls; the most:")
        for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:host_top]:
            print(f"    {e.self_cpu_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    return wall_ms, device_ms


def serve_table(spec: ModelSpec, table: str, requests: list, seed: int,
                profiled=PROFILED_SHAPES) -> int:
    """Phases 4, 13, 18, 28 and 34 for one model and table format: every
    request must launch the model's forward kernel once and no other kernel.
    Requests go through ``make_serving_fn``'s captured scorer: each request
    shape's first request runs eagerly, its second captures a CUDA graph and
    replays it, and the timed and profiled requests are replays. The plain
    comparison scores through a second scorer made inside the swap: its one
    request of each shape runs eagerly, so the plain version runs, and no
    kernel counter may move (a captured graph would ignore the swap).
    Returns the number of requests served with the kernel."""
    tag = f"[{spec.name} {table}]"
    kernel = spec.forward_kernel
    rng = np.random.default_rng(seed + (1 if table == "f32" else 2))
    leaves = spec.leaves(rng, table)
    model = params_from_jax(leaves, spec.make(table, "cuda", seed))
    serve = Trainer(model).make_serving_fn()
    path = spec.tables[table]
    big = functools.reduce(getattr, path.split("/"), model)
    print(f"{tag} table {path} {big.nbytes / 1e6:.1f} MB on the card")

    def request(label, req, fn=serve, want=None):
        before = counts()
        out = fn(req)
        torch.cuda.synchronize()
        check_launches(f"{tag} {label}", before, {kernel: 1} if want is None else want)
        return out

    for name, req, _ in requests:  # warm-up (eager), then the capture and its replay
        request(f"warm-up {name}", req)
        request(f"capture {name}", req)

    scores = {}
    for name, req, shape in requests:
        times = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            out = request(name, req)
            times.append(time.perf_counter() - t0)
        if tuple(out.shape) != shape or not torch.isfinite(out).all():
            raise AssertionError(f"{tag} {name}: scores {tuple(out.shape)}, want {shape}, "
                                 f"finite={bool(torch.isfinite(out).all())}")
        scores[name] = out
        ms = 1e3 * float(np.median(times))
        examples = int(np.prod(shape))
        print(f"{tag} {name:18s} median {ms:8.3f} ms  min {1e3 * min(times):8.3f} ms  "
              f"{examples / (ms / 1e3):12.0f} ex/s  (host clock, {REPEATS} captured requests)")

    for name, req, shape in requests:
        if shape in profiled:
            profile_call(lambda: serve(req), f"{tag} {name} (replay)", {kernel: 1})

    with spec.plain_forward(model):
        plain = Trainer(model).make_serving_fn()  # its first request of a shape runs eagerly
        for name, req, _ in requests:
            err = close(scores[name], request(f"{name} plain", req, plain, {}))
            what = f"kernel vs plain {kernel.__name__}" if kernel else "captured vs eager"
            print(f"{tag} {name:18s} {what} on the card: max abs err {err:.3e} (no kernel "
                  f"launched in the plain run)")

    cpu_model = params_from_jax(leaves, spec.make(table, "cpu", seed))
    name, req, _ = requests[spec.cpu_request]
    want = Trainer(cpu_model, device="cpu").make_serving_fn()(req)
    err = close(scores[name].cpu(), want)
    print(f"{tag} {name:18s} card vs CPU (plain) port: max abs err {err:.3e}")
    return (2 + REPEATS) * len(requests) + sum(shape in profiled for _, _, shape in requests)


def time_cuda(fn, iters: int = 50, warmup: int = 5) -> float:
    """Device ms a call: CUDA events around ``iters`` calls queued behind a
    device-side spin of about 1 ms a call, so the host has enqueued them
    before the first one starts and the events time the device, not the
    host's enqueue (a call that synchronises inside waits the spin out)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HEADSTART_CYCLES * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_cross(rng: np.random.Generator, batch: int, dim: int = DIM) -> dict:
    """Phase 5 at one shape: kernel, plain version and the per-layer cuBLAS
    ``addmm`` loop (CUDA events, median of 3 interleaved rounds), the bound
    and the form that ran."""
    x0, ws, bs = cross_inputs(rng, batch, dim, "cuda")

    def library():  # cuBLAS yardstick, never called by the port
        xl = x0
        for layer in range(CROSS_LAYERS):
            xl = torch.addcmul(xl, x0, torch.addmm(bs[layer], xl, ws[layer]))
        return xl

    close(library(), cross_network_plain(x0, ws, bs))
    flops = 2 * batch * dim * dim * CROSS_LAYERS + 3 * batch * dim * CROSS_LAYERS
    iters = 50 if flops < 1e11 else 10
    runs = {"ms": [], "plain_ms": [], "library_ms": []}
    for _ in range(3):
        runs["ms"].append(time_cuda(lambda: cross_network(x0, ws, bs), iters))
        runs["plain_ms"].append(time_cuda(lambda: cross_network_plain(x0, ws, bs), iters))
        runs["library_ms"].append(time_cuda(library, iters))
    nbytes = 4 * (2 * batch * dim + CROSS_LAYERS * dim * dim + CROSS_LAYERS * dim)
    ops_ms, bytes_ms = 1e3 * flops / PEAK_F32_FLOPS, 1e3 * nbytes / PEAK_BYTES_S
    timing = {k: float(np.median(v)) for k, v in runs.items()}
    timing["bound_ms"] = max(ops_ms, bytes_ms)
    timing["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    timing["form"] = plan_name(batch, dim)
    print(f"cross_network at B={batch} D={dim} ({timing['form']}): kernel {timing['ms']:.4f} ms "
          f"({flops / timing['ms'] / 1e9:.1f} TFLOP/s), plain {timing['plain_ms']:.4f} ms, addmm "
          f"loop {timing['library_ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms "
          f"({timing['bound_by']}: f32 FMA); rounds {runs}")
    return timing


def cublas_splits(x: torch.Tensor, w: torch.Tensor) -> Optional[bool]:
    """Whether cuBLAS splits k in ``torch.mm(x, w)``: a split-k reduce kernel
    in a ``torch.profiler`` trace of the call (a split-k that reduces inside
    one kernel is not seen); None where the trace holds no kernel."""
    torch.mm(x, w)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.mm(x, w)
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return any("split" in k.lower() for k in kernels) if kernels else None


def check_against_cublas() -> dict:
    """Phase 3, second part: over SWEEP_ROWS x SWEEP_DIMS at L=3 and the
    card tests' inputs, where cuBLAS splits k beside where the plan does, and
    the kernel's and cuBLAS's distances from plain (cuBLAS) and from the exact
    sums (``cross_network_exact``), as shares of rtol 1e-4 / atol 1e-6. A
    gate past D = 512 (``exact_gate``); at D <= 512 it reports the shapes
    where the kernel is outside the tolerance of cuBLAS (phase 3's first
    part and the card tests gate there)."""
    YES_NO = {True: "y", False: "n", None: "-"}
    rows = {}
    for dim in SWEEP_DIMS:
        for batch in SWEEP_ROWS:
            gen = np.random.default_rng(batch + dim)
            x0 = torch.from_numpy(gen.normal(size=(batch, dim)).astype(np.float32)).cuda()
            ws = torch.from_numpy((gen.normal(size=(3, dim, dim)) * 0.01).astype(np.float32)).cuda()
            bs = torch.from_numpy((gen.normal(size=(3, dim)) * 0.01).astype(np.float32)).cuda()
            got, want = cross_network(x0, ws, bs), cross_network_plain(x0, ws, bs)
            gate = exact_gate(got, want, cross_network_exact(x0, ws, bs))
            rows[(batch, dim)] = {"cublas_splits": cublas_splits(x0, ws[0]),
                                  "plan_splits": cross_plan(batch, dim).splits > 1,
                                  "kernel": tolerance_share(got, want),
                                  "kernel_exact": gate["kernel"], "cublas": gate["cublas"],
                                  "ok": gate["ok"] or dim <= FUSED_MAX_WIDTH}
    outside = {k: v for k, v in rows.items() if v["kernel"] > 1}
    failed = {k: v for k, v in rows.items() if not v["ok"]}
    summary = {
        "shapes": len(rows),
        "split_traced": sum(v["cublas_splits"] is not None for v in rows.values()),
        "split_agrees": sum(v["cublas_splits"] == v["plan_splits"] for v in rows.values()),
        "outside": len(outside),
        "outside_d_le_512": sum(d <= FUSED_MAX_WIDTH for _, d in outside),
        "cublas_outside_vs_f64": sum(v["cublas"] > 1 for v in rows.values()),
        "kernel_outside_vs_f64": sum(v["kernel_exact"] > 1 for v in rows.values()),
        "worst_kernel_vs_f64": max(v["kernel_exact"] for v in rows.values()),
        "worst_cublas_vs_f64": max(v["cublas"] for v in rows.values()),
        "gate_failed": len(failed)}
    print(f"B1 against cuBLAS over {summary['shapes']} shapes (B {SWEEP_ROWS}, D {SWEEP_DIMS}, "
          f"L=3): of {summary['split_traced']} traced, the plan splits k where cuBLAS does "
          f"(a split-k reduce kernel) and not elsewhere at {summary['split_agrees']}; kernel "
          f"outside rtol {RTOL} / atol {ATOL} of cuBLAS at {summary['outside']} "
          f"({summary['outside_d_le_512']} with D <= 512); outside it from float64 "
          f"products: cuBLAS at {summary['cublas_outside_vs_f64']} (worst "
          f"{summary['worst_cublas_vs_f64']:.2f}), the kernel at "
          f"{summary['kernel_outside_vs_f64']} (worst {summary['worst_kernel_vs_f64']:.2f}); "
          f"gate failed at {summary['gate_failed']}")
    print("    outside cuBLAS (B, D: kernel vs cuBLAS / kernel vs float64 / cuBLAS vs float64 "
          "shares; split by cuBLAS, plan): "
          + "; ".join(f"{b}x{d}: {v['kernel']:.2f} / {v['kernel_exact']:.2f} / "
                      f"{v['cublas']:.2f}, {YES_NO[v['cublas_splits']]}"
                      f"{YES_NO[v['plan_splits']]}" for (b, d), v in outside.items()))
    if failed:
        raise AssertionError(f"B1's gate failed at {sorted(failed)}")
    return summary


def segments(ids: np.ndarray):
    """(sorted ids, is_start, is_last) as the packed update derives them."""
    ordered = np.sort(ids)
    differs = ordered[1:] != ordered[:-1]
    return ordered, np.concatenate([[True], differs]), np.concatenate([differs, [True]])


def scan_input(ids: np.ndarray, gen: torch.Generator, table: str = "f32"):
    """The update's scan operands for these ids: grads N(0, 1) in the staging
    columns of the permuted rows, a strided slice as on the path (f32: floats
    [48, 64) of 64; int8: floats [6, 22) of the 32 that a 128-byte row
    holds), and the heads of the sorted ids."""
    _, heads, _ = segments(ids)
    width, start = (PACKED_W, 3 * EMB) if table == "f32" else (Q_W // 4, Q_BASE // 4)
    wide = torch.randn((ids.shape[0], width), device="cuda", generator=gen)
    return wide[:, start:start + EMB], torch.from_numpy(heads).cuda()


def check_seg_scan(rng: np.random.Generator, gen: torch.Generator):
    """Phase 6, scan: kernel against plain at the main-path shape, with Zipf
    skew and at 1 and 1000 rows; its look-back's edges at the main-path
    shape (``scan_edges``); E = 257, 300 and 512. Returns the main-path error
    and inputs."""
    main_ids = unified_ids(make_train_batch(rng))
    # per-field Zipf(2) ids: each field's hottest id fills ~20k rows
    hot = {f"c_{i}": np.minimum(rng.zipf(2.0, TRAIN_BATCH), VOCAB) - 1 for i in range(N_SPARSE)}
    cases = [("bench ids", main_ids, 1e-5), ("zipf(2) ids", unified_ids(hot), 1e-4),
             ("1 row", main_ids[:1], 1e-5), ("1000 rows", main_ids[:1000], 1e-5)]
    main = None
    for name, ids, atol in cases:
        x, heads = scan_input(ids, gen)
        got = segmented_sum_scan(x, heads)
        want = segmented_sum_scan_plain(x, heads)
        torch.cuda.synchronize()
        err = close(got, want, rtol=1e-5, atol=atol)
        longest = int(np.max(np.diff(np.flatnonzero(np.append(segments(ids)[1], True)))))
        print(f"segmented_sum_scan kernel vs plain  {name:12s} n={ids.shape[0]:7d} E={EMB} "
              f"longest segment {longest:6d}: max abs err {err:.3e} (atol {atol})")
        if main is None:
            main = (err, x, heads)
    scan_edges("bench ids", main[1], main[2])
    for e in (257, 300, 512):  # chunks of 256 columns
        ids = main_ids[:100_000]
        wide = torch.randn((ids.shape[0], e + 12), device="cuda", generator=gen)
        x, heads = wide[:, 5:5 + e], torch.from_numpy(segments(ids)[1]).cuda()
        err = close(segmented_sum_scan(x, heads), segmented_sum_scan_plain(x, heads), rtol=1e-5,
                    atol=1e-5)
        print(f"segmented_sum_scan kernel vs plain  bench ids    n={ids.shape[0]:7d} E={e} "
              f"(row stride {x.stride(0)}): max abs err {err:.3e}")
    return main


def dyadic_like(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """A tensor laid out as ``x`` (the same row stride and offset in its rows)
    holding multiples of 1/16 in [-0.5, 0.5]: every partial sum of up to a
    million rows is exact in f32, so any summation order gives the same
    bits."""
    n, e = x.shape
    stride, start = x.stride(0), x.storage_offset() % x.stride(0)
    wide = torch.randint(-8, 9, (n, stride), device="cuda", generator=gen).float() / 16
    return wide[:, start:start + e]


def scan_edges(label: str, x: torch.Tensor, heads: torch.Tensor) -> None:
    """B2's look-back at ``x``'s shape and layout, exact against plain on
    dyadic values (``dyadic_like``, from a generator of their own, so that
    the later phases' inputs stay as they were): one segment over every
    row, so each tile's carry comes down the whole chain of predecessors;
    then three calls queued back to back without a sync (one segment, the
    path's heads, one segment again), each handed scratch the call before
    freed, so a status word or ticket not zeroed would show; then, on ``x``
    itself, whose sums round, one segment and the path's heads each twice
    over, the same bits both times (the look-back's order is fixed). Prints
    the launch: floats a load, tiles, registers and local memory a thread,
    status bytes."""
    values = dyadic_like(x, torch.Generator(device="cuda").manual_seed(SCAN_EDGES_SEED))
    one = torch.zeros_like(heads)
    one[0] = True
    torch.cuda.synchronize()
    calls = [(values, one), (values, heads), (values, one)]
    outs = [segmented_sum_scan(v, h) for v, h in calls]
    torch.cuda.synchronize()
    for k, ((v, h), out) in enumerate(zip(calls, outs)):
        if not torch.equal(out, segmented_sum_scan_plain(v, h)):
            raise AssertionError(f"B2 {label}: call {k} of 3 back to back differs from plain on "
                                 f"exact sums")
    for name, h in (("one segment", one), ("the path's heads", heads)):
        first, again = segmented_sum_scan(x, h), segmented_sum_scan(x, h)
        if not torch.equal(first, again):
            raise AssertionError(f"B2 {label}: two calls on the same input ({name}) give "
                                 f"different bits")
    info = seg_scan_launch_info(x)
    print(f"segmented_sum_scan kernel vs plain  {label} n={x.shape[0]} E={x.shape[1]} row stride "
          f"{x.stride(0)}: one segment over every row exact; 3 calls back to back without a "
          f"sync exact; repeated calls bit-equal; launch {info}")


def time_seg_scan(x: torch.Tensor, heads: torch.Tensor) -> dict:
    """Kernel and plain version (CUDA events, median of 3 interleaved rounds)
    and the bound: read x and the flags once, write the result once. The
    look-back's status words (zeroed, published, read: three times their
    bytes at least) are scratch of this design, not bytes the scan needs:
    printed beside the bound with their share of it, never counted in it.
    Beside them
    ``slice_copy_ms``: torch's copy of the slice into a contiguous tensor,
    the same reads and writes without the scan, which a slice of 16 floats
    in 64 (or 1 in 64) cannot take at the bound's rate."""
    runs = {"ms": [], "plain_ms": [], "slice_copy_ms": []}
    copied = torch.empty(x.shape, device="cuda")
    for _ in range(3):
        runs["ms"].append(time_cuda(lambda: segmented_sum_scan(x, heads)))
        runs["plain_ms"].append(time_cuda(lambda: segmented_sum_scan_plain(x, heads), iters=10))
        runs["slice_copy_ms"].append(time_cuda(lambda: copied.copy_(x)))
    n, e = x.shape
    nbytes = 2 * n * e * 4 + n
    status = 3 * seg_scan_launch_info(x)["status_bytes"]
    share = status / nbytes
    ops_ms, bytes_ms = 1e3 * n * e / PEAK_F32_FLOPS, 1e3 * nbytes / PEAK_BYTES_S
    timing = {k: float(np.median(v)) for k, v in runs.items()}
    timing.update(library_ms=None, bound_ms=max(ops_ms, bytes_ms),
                  bound_by="operations" if ops_ms >= bytes_ms else "bytes")
    print(f"segmented_sum_scan at n={n} E={e} row stride {x.stride(0)}: kernel "
          f"{timing['ms']:.4f} ms, plain "
          f"{timing['plain_ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms "
          f"({nbytes / 1e6:.2f} MB; beside it the status words' {status / 1e6:.3f} MB, "
          f"{100 * share:.2f}%, not counted), {100 * timing['bound_ms'] / timing['ms']:.0f}% "
          f"of the bound; no single PyTorch call computes it; the slice copied to a contiguous "
          f"tensor (copy_, the same reads and writes without the scan) "
          f"{timing['slice_copy_ms']:.4f} ms; rounds {runs}")
    return timing


def check_and_time_scatter(rng: np.random.Generator, gen: torch.Generator, table_kind: str,
                           ids=None, vocab_rows: int = N_SPARSE * VOCAB,
                           widths=(PACKED_W, Q_W)):
    """Phases 6 and 17, scatter: the update's last-of-segment rows into the
    packed table (f32 ``[V, widths[0]]``, int8 ``[V, widths[1]]`` u8; V and
    the ids ``bench.py``'s unless given), bit-exact against plain; then
    kernel, plain (which filters the ids inside), ``index_copy_`` of the
    surviving rows (filtered beforehand, untimed) and the bound for this
    data."""
    if ids is None:
        ids = unified_ids(make_train_batch(rng))
    ordered, _, last = segments(ids)
    n = ordered.shape[0]
    safe = torch.from_numpy(np.where(last, ordered, vocab_rows + np.arange(n)).astype(np.int32))
    safe = safe.cuda()
    if table_kind == "f32":
        width, row_bytes = widths[0], 4 * widths[0]
        table = torch.randn((vocab_rows, width), device="cuda", generator=gen)
        rows = torch.randn((n, width), device="cuda", generator=gen)
    else:
        width = row_bytes = widths[1]
        table = torch.randint(0, 256, (vocab_rows, width), dtype=torch.uint8, device="cuda",
                              generator=gen)
        rows = torch.randint(0, 256, (n, width), dtype=torch.uint8, device="cuda", generator=gen)
    want = scatter_set_rows_plain(table.clone(), rows, safe)
    scatter_set_rows(table, rows, safe)
    torch.cuda.synchronize()
    if not torch.equal(table, want):
        raise AssertionError("scatter_set_rows kernel differs from its plain version")
    del want
    print(f"scatter_set_rows kernel vs plain  n={n} ({int(last.sum())} rows of {row_bytes} bytes "
          f"kept) into [{vocab_rows}, {width}] {table.dtype}: bit-exact")
    return 0.0, time_scatter("", table, rows, safe)


def written_sectors(ids: torch.Tensor, row_bytes: int) -> int:
    """The 32-byte sectors that rows of ``row_bytes`` bytes at these unique
    ids cover: each row's span, less the sectors that neighbouring rows
    (in id order) share."""
    ids = torch.sort(ids)[0]
    first, last = ids * row_bytes // 32, ((ids + 1) * row_bytes - 1) // 32
    return int((last - first + 1).sum() - (first[1:] == last[:-1]).sum())


def time_scatter(tag: str, table: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor) -> dict:
    """B4 on these arguments (``time_cuda``, median of 3 interleaved rounds)
    beside its plain version (which filters the ids inside) and
    ``index_copy_`` of the kept rows (filtered beforehand, untimed); its
    bytes' bound (the ids read, each kept row read and written) and its
    sectors' bound (the ids and kept rows read, each 32-byte sector a kept
    row writes counted whole); its plan, grid and registers. The same
    table takes every call, so a table that fits the 50 MB L2 stays there,
    as in a step."""
    n, row_bytes = ids.shape[0], table.shape[1] * table.element_size()
    keep = (ids >= 0) & (ids < table.shape[0])
    kept_ids, kept_rows = ids[keep].long(), rows[keep]
    kept = kept_ids.shape[0]
    runs = {"ms": [], "plain_ms": [], "library_ms": []}
    for _ in range(3):
        runs["ms"].append(time_cuda(lambda: scatter_set_rows(table, rows, ids)))
        runs["plain_ms"].append(time_cuda(lambda: scatter_set_rows_plain(table, rows, ids)))
        runs["library_ms"].append(time_cuda(lambda: table.index_copy_(0, kept_ids, kept_rows)))
    timing = {k: float(np.median(v)) for k, v in runs.items()}
    nbytes = 2 * kept * row_bytes + 4 * n
    sectors = written_sectors(kept_ids, row_bytes)
    launch = scatter_launch_info(table, rows, n)
    timing.update(bound_ms=1e3 * nbytes / PEAK_BYTES_S, bound_by="bytes",
                  sector_bound_ms=1e3 * (4 * n + kept * row_bytes + 32 * sectors) / PEAK_BYTES_S,
                  kept=kept, row_bytes=row_bytes, table_mb=table.numel() * table.element_size() / 1e6,
                  plan=launch)
    print(f"{tag}{' ' if tag else ''}scatter_set_rows at n={n}, {kept} kept rows of {row_bytes} "
          f"bytes into {list(table.shape)} {table.dtype} ({timing['table_mb']:.1f} MB): kernel "
          f"{timing['ms']:.4f} ms, plain {timing['plain_ms']:.4f} ms, index_copy_ "
          f"{timing['library_ms']:.4f} ms ({timing['library_ms'] / timing['ms']:.2f}x the "
          f"kernel's time), bound {timing['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB; "
          f"{100 * timing['bound_ms'] / timing['ms']:.0f}% of it), sectors' bound "
          f"{timing['sector_bound_ms']:.4f} ms ({sectors} sectors written); plan "
          f"{launch['unit']}-byte units, {launch['units']} a row, {launch['lanes']} lanes of "
          f"{launch['lane_units']}, {launch['group_rows']} rows a group, {launch['block_slots']} "
          f"slots a block, {launch['blocks']} blocks, {launch['registers']} registers, "
          f"{launch['local_bytes']} B local; rounds {runs}")
    return timing


# Phase 44, B4 against plain at every branch of scatter_plan: (label, dtype,
# width, table rows, the table's byte offset, slots, ids). "sorted" ids keep
# each segment's last slot and route the others past V, as the packed update
# does; "unsorted" ones are unique and shuffled, with negative and too large
# ids among them.
B4_CHECKS = (
    *((f"[V, {width}] {str(dtype)[6:]}", dtype, width, 100_000, 0, 300_000, "sorted")
      for dtype, width in ((torch.float32, 1), (torch.float32, 4), (torch.float32, 13),
                           (torch.float32, 16), (torch.float32, 48), (torch.float32, 64),
                           (torch.float32, 256), (torch.uint8, 7), (torch.uint8, 16),
                           (torch.uint8, 128), (torch.uint8, 192), (torch.uint8, 384),
                           (torch.int8, 16), (torch.bfloat16, 64))),
    ("[V, 600] float32, a lane looping", torch.float32, 600, 20_000, 0, 60_000, "sorted"),
    ("8-byte units: [V, 4] float32 at byte 8", torch.float32, 4, 100_000, 8, 300_000, "sorted"),
    ("4-byte units: [V, 4] float32 at byte 4", torch.float32, 4, 100_000, 4, 300_000, "sorted"),
    ("4-byte units: [V, 64] float32 at byte 4", torch.float32, 64, 100_000, 4, 300_000, "sorted"),
    ("2-byte units: [V, 8] bfloat16 at byte 2", torch.bfloat16, 8, 100_000, 2, 300_000,
     "sorted"),
    ("1-byte units: [V, 16] uint8 at byte 1", torch.uint8, 16, 100_000, 1, 300_000, "sorted"),
    ("unsorted [V, 1] float32", torch.float32, 1, 100_000, 0, 50_000, "unsorted"),
    ("unsorted [V, 16] int8", torch.int8, 16, 100_000, 0, 50_000, "unsorted"),
    ("unsorted [V, 64] float32", torch.float32, 64, 100_000, 0, 50_000, "unsorted"),
    ("unsorted [V, 384] uint8", torch.uint8, 384, 100_000, 0, 50_000, "unsorted"),
    ("n = 0", torch.float32, 64, 1000, 0, 0, "unsorted"),
    ("n = 1, [V, 1] float32", torch.float32, 1, 1000, 0, 1, "sorted"),
    ("n = 1, [V, 256] float32", torch.float32, 256, 1000, 0, 1, "sorted"),
    ("n = 1025, a block of 1024 slots and one", torch.float32, 1, 100_000, 0, 1025, "unsorted"),
    ("n = 257, a block of 256 slots and one", torch.float32, 16, 100_000, 0, 257, "unsorted"),
    ("n = 17, a block of 16 slots and one", torch.float32, 256, 100_000, 0, 17, "unsorted"),
)
# Phase 44's timed widths, the main paths' rows at the shapes of their calls
# in phases 6, 17 and 41: (label, dtype, width, table rows, the ids' source,
# their routing). "unique": each id once in order, then padding at V (the
# classic update); "field": one field's ids so, the padding at V + slot (the
# unpacked update); "last": each sorted segment's last slot kept, the others
# at V + slot (the packed update).
B4_WIDTHS = (
    ("4 B: classic scales, rowwise accumulators", torch.float32, 1, N_SPARSE * VOCAB, "bench",
     "unique"),
    ("16 B: classic int8 rows", torch.int8, EMB, N_SPARSE * VOCAB, "bench", "unique"),
    ("64 B: per-field f32 tables and moments", torch.float32, EMB, VOCAB, "field", "field"),
    ("128 B: int8 packed rows", torch.uint8, Q_W, N_SPARSE * VOCAB, "bench", "last"),
    ("128 B: bf16 packed rows", torch.bfloat16, PACKED_W, N_SPARSE * VOCAB, "bench", "last"),
    ("192 B: byte rows (an f32 view)", torch.float32, 48, N_SPARSE * VOCAB, "bench", "last"),
    ("256 B: f32 packed rows", torch.float32, PACKED_W, N_SPARSE * VOCAB, "bench", "last"),
    ("384 B: DIN int8 rows", torch.uint8, DIN_Q_W, DIN_ITEMS, "din", "last"),
    ("1 KB: DIN f32 packed rows", torch.float32, DIN_PACKED_W, DIN_ITEMS, "din", "last"),
)
B4_SEED = 44  # offset of phase 44's generators from --seed


def routed_ids(ids: np.ndarray, v: int, routing: str) -> np.ndarray:
    """The int32 ids a B4 call gets from these raw ids (``B4_WIDTHS``)."""
    if routing == "last":
        ordered, _, last = segments(ids)
        return np.where(last, ordered, v + np.arange(ordered.shape[0])).astype(np.int32)
    unique = np.unique(ids)
    pad = np.arange(unique.shape[0], ids.shape[0])
    return np.concatenate([unique, np.full_like(pad, v) if routing == "unique"
                           else v + pad]).astype(np.int32)


def b4_values(gen: torch.Generator, dtype: torch.dtype, shape) -> torch.Tensor:
    if dtype.is_floating_point:
        return torch.randn(shape, device="cuda", generator=gen).to(dtype)
    low = -128 if dtype == torch.int8 else 0
    return torch.randint(low, low + 256, shape, dtype=dtype, device="cuda", generator=gen)


def b4_check_ids(rng: np.random.Generator, v: int, n: int, order: str) -> np.ndarray:
    """``B4_CHECKS``' ids: sorted and routed as the packed update does, or
    unique and shuffled with one slot in 50 negative or at V and above."""
    if order == "sorted":
        return routed_ids(rng.integers(0, v, n), v, "last")
    ids = rng.permutation(v)[:n].astype(np.int64)
    bad = np.array([-1, -7, -2**31, v, v + 3, 2**31 - 1])
    spots = np.arange(0, n, 50)
    ids[spots] = bad[np.arange(spots.shape[0]) % bad.shape[0]]
    return ids.astype(np.int32)


def b4_sweep(seed: int) -> dict:
    """Phase 44: B4 against plain at ``B4_CHECKS`` (bit-exact, one launch a
    call and none at n = 0), then each of ``B4_WIDTHS`` checked and timed
    (``time_scatter``). Its generators are its own (``B4_SEED``)."""
    tag = "[phase 44 B4]"
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + B4_SEED)
    gen = torch.Generator(device="cuda").manual_seed(seed + B4_SEED)
    plans = set()
    for label, dtype, width, v, offset, n, order in B4_CHECKS:
        size = v * width * dtype.itemsize
        buffer = torch.empty(size + 16, dtype=torch.uint8, device="cuda")
        table = buffer[offset:offset + size].view(dtype).view(v, width)
        table.copy_(b4_values(gen, dtype, (v, width)))
        rows = b4_values(gen, dtype, (n, width))
        ids = torch.from_numpy(b4_check_ids(rng, v, n, order)).cuda()
        plan = scatter_plan(width * dtype.itemsize, table.data_ptr() | rows.data_ptr())
        want = scatter_set_rows_plain(table.clone(), rows, ids)
        before = scatter_set_rows.launches
        scatter_set_rows(table, rows, ids)
        torch.cuda.synchronize()
        launched = scatter_set_rows.launches - before
        if not torch.equal(table, want) or launched != (1 if n else 0):
            raise AssertionError(f"{tag} {label}: differs from plain or launched {launched} times")
        plans.add((plan.unit, plan.lanes, plan.lane_units))
        print(f"{tag} {label}, V={v}, n={n}, {order} ids: bit-exact, {launched} launch; plan "
              f"{plan.unit}-byte units, {plan.units} a row, {plan.lanes} lanes of "
              f"{plan.lane_units}, {plan.group_rows} rows a group")
        del buffer, table, rows, want
    units = sorted({unit for unit, _, _ in plans})
    if units != [1, 2, 4, 8, 16] or not {1, 32} <= {lanes for _, lanes, _ in plans}:
        raise AssertionError(f"{tag} the checks reach units {units} and plans {sorted(plans)}")
    batch = make_train_batch(rng)
    sources = {"bench": unified_ids(batch), "field": batch["c_0"].astype(np.int64),
               "din": din_item_ids(make_din_batch(rng))}
    widths = {}
    for label, dtype, width, v, source, routing in B4_WIDTHS:
        ids = torch.from_numpy(routed_ids(sources[source], v, routing)).cuda()
        table = b4_values(gen, dtype, (v, width))
        rows = b4_values(gen, dtype, (ids.shape[0], width))
        want = scatter_set_rows_plain(table.clone(), rows, ids)
        scatter_set_rows(table, rows, ids)
        torch.cuda.synchronize()
        if not torch.equal(table, want):
            raise AssertionError(f"{tag} {label}: differs from plain")
        del want
        widths[label] = {"shape": f"n={ids.shape[0]} into [{v}, {width}] {str(dtype)[6:]}",
                         **time_scatter(f"{tag} {label}:", table, rows, ids)}
        del table, rows
        torch.cuda.empty_cache()
    for label, t in widths.items():
        print(f"{tag} {label:44s} kernel {t['ms']:.4f} ms, index_copy_ {t['library_ms']:.4f}, "
              f"bound {t['bound_ms']:.4f} (sectors {t['sector_bound_ms']:.4f}), "
              f"{t['plan']['lanes']} lanes of {t['plan']['lane_units']} x "
              f"{t['plan']['unit']} B, {t['plan']['registers']} registers")
    seconds = time.perf_counter() - t0
    print(f"phase 44: B4 at {len(B4_CHECKS)} checks and {len(widths)} timed widths in "
          f"{seconds:.1f} s")
    return {"checks": len(B4_CHECKS), "plans_checked": sorted(plans), "widths": widths,
            "seconds": seconds}


def check_cross_grad(rng: np.random.Generator, gen: torch.Generator) -> float:
    """Phase 6, gradient: dx0, dws, dbs through the Function (kernel forward)
    against autograd through the plain version, on the card, at B=4096; then
    the forward+backward time of both at B=32768."""
    worst = 0.0
    for batch in (4096, TRAIN_BATCH):
        arrays = cross_inputs(rng, batch, DIM, "cuda")
        upstream = torch.randn((batch, DIM), device="cuda", generator=gen)

        def grads(fn):
            leaves = [a.detach().clone().requires_grad_() for a in arrays]
            out = fn(*leaves)
            out.backward(upstream)
            return [t.grad for t in leaves]

        if batch == 4096:
            before = cross_network.launches
            got = grads(cross_network)
            if cross_network.launches != before + 1:
                raise AssertionError("the cross Function did not launch the kernel")
            for name, a, b in zip(("dx0", "dws", "dbs"), got, grads(cross_network_plain)):
                err = close(a, b)
                worst = max(worst, err)
                print(f"cross_network gradient (kernel Function vs plain autograd) B={batch} "
                      f"{name}: max abs err {err:.3e}")
        else:
            kernel_ms = time_cuda(lambda: grads(cross_network), iters=10)
            plain_ms = time_cuda(lambda: grads(cross_network_plain), iters=10)
            print(f"cross_network forward+backward at B={batch}: Function (kernel forward, "
                  f"torch backward) {kernel_ms:.4f} ms, plain autograd {plain_ms:.4f} ms")
    return worst


def requantize_inputs(rng: np.random.Generator, gen: torch.Generator, seed: int, ids=None,
                      vocab_rows: int = N_SPARSE * VOCAB, emb: int = EMB,
                      path: str = TABLES["int8"]):
    """The int8 update's operands of ``requantize_rows`` at a main path's
    shape: a random int8 packed ``[V, W]`` table (rows N(0, 0.01),
    accumulators U(0, 1e-3)) gathered at ``ids`` (``bench.py``-drawn unless
    given), grads N(0, 1e-2) staged into the rows, the rows permuted into id
    order, the grads summed by the scan kernel, and the salt of step 1 for
    seed ``seed`` and the table's ``path``. Returns (moved, g, sorted ids,
    salt)."""
    base = packed_q_base(emb, 8, 1)
    q, scale = quantize_rows(torch.randn((vocab_rows, emb), device="cuda", generator=gen) * 0.01)
    acc = torch.rand((vocab_rows,), device="cuda", generator=gen) * 1e-3
    table = pack_quantized_table(q, scale, acc, emb)
    del q, scale, acc
    if ids is None:
        ids = unified_ids(make_train_batch(rng))
    ids = torch.from_numpy(ids.astype(np.int32)).cuda()
    staged = table.index_select(0, ids)
    del table
    dvec = torch.randn((ids.shape[0], emb), device="cuda", generator=gen) * 1e-2
    staged[:, base:base + 4 * emb] = dvec.view(torch.uint8)
    sorted_ids, order = torch.sort(ids, stable=True)
    moved = staged.index_select(0, order)
    heads = torch.cat([torch.ones(1, dtype=torch.bool, device="cuda"),
                       sorted_ids[1:] != sorted_ids[:-1]])
    g = segmented_sum_scan(moved.view(torch.float32)[:, base // 4:base // 4 + emb], heads)
    salt = table_rounding_salt(split(prng_key(seed))[1], 1, path)
    return moved, g, sorted_ids, salt


def rows_agree(got: torch.Tensor, want: torch.Tensor, label: str, emb: int = EMB) -> float:
    """Requantized rows, kernel against plain: scale and accumulator rtol
    3e-7, q bytes identical except on a row whose scale or accumulator
    differs (there by at most one), every byte after the accumulator zero.
    Returns the max abs error of the dequantized rows."""
    (gq, gs, ga), (wq, ws, wa) = (unpack_quantized_table(t, emb) for t in (got, want))
    close(gs, ws, rtol=3e-7, atol=0.0)
    close(ga, wa, rtol=3e-7, atol=0.0)
    diff = (gq.int() - wq.int()).abs()
    same = (gs == ws) & (ga == wa)
    if int((diff * same[:, None]).max()) or int(diff.max()) > 1 or got[:, emb + 8:].any():
        raise AssertionError(f"{label}: q bytes differ by up to {int(diff.max())} "
                             f"({int((diff > 0).sum())} of them), or a staging byte is set")
    err = (dequant_packed_rows(got, emb) - dequant_packed_rows(want, emb)).abs()
    print(f"requantize_rows kernel vs plain  {label:24s} n={got.shape[0]:7d}: "
          f"{int((diff > 0).sum())} q bytes, {int((gs != ws).sum())} scales, "
          f"{int((ga != wa).sum())} accumulators differ; dequantized max abs err "
          f"{float(err.max()):.3e}")
    return float(err.max())


def time_requantize(moved: torch.Tensor, g: torch.Tensor, ids: torch.Tensor, salt: int,
                    lr: float, emb: int, label: str) -> dict:
    """B3 and its plain version at one shape (CUDA events, median of 3
    interleaved rounds), its bound, its launch (the group of lanes a row,
    rows a warp, the grid, registers a thread) and its share of the
    bound. The kernel reads the salt from a device word, as in a step."""
    word = salt_word(salt, "cuda")
    runs = {"ms": [], "plain_ms": []}
    for _ in range(3):
        runs["ms"].append(time_cuda(lambda: requantize_rows(moved, g, ids, word, lr, emb)))
        runs["plain_ms"].append(time_cuda(
            lambda: requantize_rows_plain(moved, g, ids, salt, lr, emb), iters=10))
    n, w = moved.shape
    # what the function needs: q || scale || acc, grads and id of each row, the new row
    nbytes = n * ((emb + 8) + 4 * emb + 4 + w)
    timing = {k: float(np.median(v)) for k, v in runs.items()}
    timing.update(library_ms=None, bound_ms=1e3 * nbytes / PEAK_BYTES_S, bound_by="bytes",
                  launch=requantize_launch_info(n, w, emb))
    launch = timing["launch"]
    print(f"requantize_rows at {label} n={n} W={w} E={emb}: kernel {timing['ms']:.4f} ms, plain "
          f"{timing['plain_ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} "
          f"MB), {timing['bound_ms'] / timing['ms']:.1%} of the bound; {launch['group']} lanes "
          f"a row, {launch['rows_per_warp']} rows a warp, {launch['unit']}-byte stores, grid "
          f"{launch['grid']} blocks, {launch['registers']} registers; no single PyTorch call "
          f"computes it; rounds {runs}")
    return timing


def check_and_time_requantize(rng: np.random.Generator, gen: torch.Generator, seed: int):
    """Phase 9: B3 against plain at the int8 DCN-v2 step's shape and the
    edge cases, and at DIN's step shape (the item table's 90,112 ids of a
    batch, 384-byte rows, E=64, at the model's table lr); then B3 and plain
    timed at both. Returns (main-path error, timing, DIN's timing)."""
    moved, g, ids, salt = requantize_inputs(rng, gen, seed)
    zero_moved, zero_g = moved[:1000].clone(), g[:1000].clone()
    zero_moved[7, :EMB] = 0
    zero_g[7] = 0.0
    cases = [("bench ids", moved, g, ids, TRAIN_LR), ("1 row", moved[:1], g[:1], ids[:1], TRAIN_LR),
             ("1000 rows", moved[:1000], g[:1000], ids[:1000], TRAIN_LR),
             ("1000 rows, one all zero", zero_moved, zero_g, ids[:1000], TRAIN_LR),
             ("1000 rows, lr 10", moved[:1000], g[:1000], ids[:1000], 10.0)]
    errs = []
    for label, m, gg, ii, lr in cases:
        got = requantize_rows(m, gg, ii, salt, lr, EMB)
        want = requantize_rows_plain(m, gg, ii, salt, lr, EMB)
        torch.cuda.synchronize()
        errs.append(rows_agree(got.cpu(), want.cpu(), label))
        if label.endswith("all zero"):
            _, scale, _ = unpack_quantized_table(got[7:8].cpu(), EMB)
            if float(scale[0]) != 1.0 or got[7, :EMB].any():
                raise AssertionError("an all-zero row did not keep scale 1 and q 0")
        q_new = unpack_quantized_table(got.cpu(), EMB)[0]
        if label.endswith("lr 10") and int(q_new.abs().max()) != 127:
            raise AssertionError("lr 10 did not reach the clip")
    # DIN's operands from generators of their own, so that the later phases'
    # data does not hang on this one's draws
    din_gen = torch.Generator(device="cuda").manual_seed(seed + DIN_REQUANTIZE_SEED)
    din_ids = din_item_ids(make_din_batch(np.random.default_rng(seed + DIN_REQUANTIZE_SEED)))
    din_moved, din_g, din_ids, din_salt = requantize_inputs(
        rng, din_gen, seed, ids=din_ids, vocab_rows=DIN_ITEMS, emb=DIN_EMB,
        path=DIN_TABLES["int8"])
    got = requantize_rows(din_moved, din_g, din_ids, din_salt, DIN_TABLE_LR, DIN_EMB)
    want = requantize_rows_plain(din_moved, din_g, din_ids, din_salt, DIN_TABLE_LR, DIN_EMB)
    torch.cuda.synchronize()
    rows_agree(got.cpu(), want.cpu(), "DIN ids", emb=DIN_EMB)
    del got, want
    timing = time_requantize(moved, g, ids, salt, TRAIN_LR, EMB, "the int8 step's")
    din_timing = time_requantize(din_moved, din_g, din_ids, din_salt, DIN_TABLE_LR, DIN_EMB,
                                 "DIN's")
    return errs[0], timing, din_timing


def b8_edge_rows(emb: int = EMB):
    """Rows at B8's edges, with their bits: an all-zero row (scale 1);
    quotients that land on integers (scale 2**-7, u 0 and u 1/2, bits
    ``0x80000000``); 127 + u rounding up to 128 (bits ``0xFFFFFFFF``); an
    absmax whose quotient lies just over 127, so -128 before the clip; and
    random bits, half of them at 2**31 and above."""
    step = 2.0**-7
    rows = torch.zeros((6, emb), device="cuda")
    bits = torch.zeros((6, emb), dtype=torch.int32, device="cuda")
    rows[1] = (torch.arange(emb, device="cuda") - emb // 2) * step
    rows[1, 0] = -127 * step
    rows[2] = (torch.arange(emb, device="cuda") + 0.5) * step
    rows[2, -1] = 127 * step
    bits[2] = -2**31
    rows[3, 0] = 127 * step
    bits[3] = -1
    over = next(v for v in np.linspace(0.5, 1.0, 4001, dtype=np.float32)
                if v / (v / np.float32(127)) > np.float32(127))
    rows[4, 0] = -float(over)
    rows[5] = torch.linspace(-0.01, 0.02, emb, device="cuda")
    bits[5] = torch.randint(-2**31, 2**31 - 1, (emb,), dtype=torch.int32, device="cuda")
    return rows, bits


def b8_agree(label: str, rows: torch.Tensor, bits: Optional[torch.Tensor] = None,
             ids: Optional[torch.Tensor] = None, salt: Optional[int] = None) -> float:
    """B8 against its plain version on the card, bit for bit (q and scale),
    with given bits or keyed by ``ids`` and ``salt`` (the kernel's hash
    against the torch hash); returns the max abs error of the dequantized
    rows (0)."""
    if bits is not None:
        q, scale = stochastic_quantize_rows(rows, bits)
        want_q, want_scale = stochastic_quantize_rows_plain(rows, bits)
        form = f"given bits, {int((bits < 0).sum())} bit patterns of 2**31 and above"
    else:
        q, scale = stochastic_quantize_rows(rows, ids=ids, salt=salt)
        want_q, want_scale = stochastic_quantize_rows_keyed_plain(rows, ids, salt)
        form = f"keyed, salt {salt:#010x}, ids up to {int(ids.max())}"
    torch.cuda.synchronize()
    q_off = int((q != want_q).sum())
    s_off = int((scale.view(torch.int32) != want_scale.view(torch.int32)).sum())
    if q_off or s_off:
        raise AssertionError(f"B8 vs plain {label}: {q_off} q values and {s_off} scales differ")
    err = float((q.float() * scale[:, None] - want_q.float() * want_scale[:, None]).abs().max())
    print(f"stochastic_quantize_rows kernel vs plain  {label:28s} [{rows.shape[0]}, "
          f"{rows.shape[1]}]: q and scale bit-equal; {form}, {int((scale == 1).sum())} scales "
          f"of 1")
    return err


def b8_bound(n: int, e: int, keyed: bool) -> dict:
    """B8's bound: each input read once, each output written once. Keyed:
    rows (4e bytes) and the id (4) read, q (e) and the scale (4) written;
    given: the bits (4e) read in place of the id."""
    nbytes = n * (4 * e + (4 if keyed else 4 * e) + e + 4)
    return {"bound_ms": 1e3 * nbytes / PEAK_BYTES_S, "bound_by": "bytes", "bytes": nbytes}


def check_and_time_b8(rng: np.random.Generator, gen: torch.Generator, seed: int):
    """Phase 27: B8 against its plain version bit for bit, keyed (the kernel
    hashes the ids) at the classic step's shape (the dedup of a ``bench.py``
    batch's 851,968 ids, rows N(0, 0.01), the table's step-1 salt), at
    ``[1, 1]``, ``[7, 1]``, ``[1000, 64]`` and ``[1000, 100]`` with ids up to
    2**31 - 1 and salts of 2**31 and above, and on the edge rows; with given
    bits (the TPU kernel's contract) at the classic step's shape (the same
    bits, hashed in torch), at ``[1000, 64]`` of random bits and on the edge
    rows. Then both forms, their plain versions, the id-keyed hash in torch
    (the pass the keyed form replaces) and the dedup timed (CUDA events,
    median of 3 interleaved rounds) beside B8's bounds, the registers a
    thread, and the step's two scatter-sets and the whole classic update of
    a ``[2.6M, 16]`` int8 table timed alone. Returns (error, B8's keyed
    timing with the given form's beside it, the step's parts in ms)."""
    ids = torch.from_numpy(unified_ids(make_train_batch(rng)).astype(np.int32)).cuda()
    dvec = torch.randn((ids.shape[0], EMB), device="cuda", generator=gen) * 1e-2
    grads = dedup_row_grads(ids, dvec)
    salt = table_rounding_salt(split(prng_key(seed))[1], 1, TABLES["classic"])

    def hashed():
        return rounding_bits_i32(id_keyed_rounding_bits(grads.ids, EMB, salt))

    bits = hashed()
    rows = torch.randn((ids.shape[0], EMB), device="cuda", generator=gen) * 0.01
    err = b8_agree("bench ids, keyed", rows, ids=grads.ids, salt=salt)
    err = max(err, b8_agree("bench ids, given id-keyed bits", rows, bits))
    big_ids = torch.randint(0, 2**31 - 1, (1000,), dtype=torch.int32, device="cuda",
                            generator=gen)
    big_ids[0] = 2**31 - 1
    keyed_cases = (("1 x 1", rows[:1, :1], 2**31), ("7 x 1", rows[:7, :1], 2**31 + 7),
                   ("1000 x 64", torch.randn((1000, 64), device="cuda", generator=gen) * 0.01,
                    0xFFFFFFFF),
                   ("1000 x 100", torch.randn((1000, 100), device="cuda", generator=gen) * 0.01,
                    0x9E3779B9))
    for label, r, key_salt in keyed_cases:
        err = max(err, b8_agree(f"{label}, keyed", r.contiguous(), ids=big_ids[:r.shape[0]],
                                salt=key_salt))
    edge_rows, edge_bits = b8_edge_rows()
    edge_ids = torch.tensor([0, 1, 2**31 - 1, 77, 2**30, 123_456_789], dtype=torch.int32,
                            device="cuda")
    err = max(err, b8_agree("edge rows, keyed", edge_rows, ids=edge_ids, salt=0xFFFFFFFF))
    wide = torch.randn((1000, 64), device="cuda", generator=gen) * 0.01
    wide_bits = torch.randint(-2**31, 2**31 - 1, (1000, 64), dtype=torch.int32, device="cuda",
                              generator=gen)
    for label, r, b in (("1000 x 64, given bits", wide, wide_bits),
                        ("edge rows, given bits", edge_rows, edge_bits)):
        err = max(err, b8_agree(label, r, b))
    edge_q, _ = stochastic_quantize_rows(edge_rows, edge_bits)
    if edge_q[3, 0] != 127 or edge_q[4, 0] != -127 or edge_q[2, :-1].tolist() != list(
            range(1, EMB)):
        raise AssertionError(f"B8 edge rows: {edge_q.tolist()}")
    for keyed in (True, False):
        print(f"stochastic_quantize_rows launch at E={EMB}, {'keyed' if keyed else 'given bits'}: "
              f"{quantize_launch_info(EMB, keyed)}; at E=1: {quantize_launch_info(1, keyed)}")

    runs = {"ms": [], "plain_ms": [], "given_ms": [], "given_plain_ms": [], "hash_ms": [],
            "dedup_ms": []}
    word = salt_word(salt, "cuda")  # the salt as a step reads it: a device word
    for _ in range(3):
        runs["ms"].append(time_cuda(lambda: stochastic_quantize_rows(rows, ids=grads.ids,
                                                                     salt=word)))
        runs["plain_ms"].append(time_cuda(
            lambda: stochastic_quantize_rows_keyed_plain(rows, grads.ids, salt), iters=10))
        runs["given_ms"].append(time_cuda(lambda: stochastic_quantize_rows(rows, bits)))
        runs["given_plain_ms"].append(time_cuda(lambda: stochastic_quantize_rows_plain(rows, bits),
                                                iters=10))
        runs["hash_ms"].append(time_cuda(hashed, iters=10))
        runs["dedup_ms"].append(time_cuda(lambda: dedup_row_grads(ids, dvec), iters=10))
    n = rows.shape[0]
    med = {k: float(np.median(v)) for k, v in runs.items()}
    keyed_bound, given_bound = b8_bound(n, EMB, True), b8_bound(n, EMB, False)
    timing = {"ms": med["ms"], "plain_ms": med["plain_ms"], "library_ms": None,
              "bound_ms": keyed_bound["bound_ms"], "bound_by": "bytes",
              "given_bits": {"ms": med["given_ms"], "plain_ms": med["given_plain_ms"],
                             "library_ms": None, "bound_ms": given_bound["bound_ms"],
                             "bound_by": "bytes"}}
    parts = {k: med[k] for k in ("hash_ms", "dedup_ms")}
    q_table, s_table = quantize_rows(torch.randn((N_SPARSE * VOCAB, EMB), device="cuda",
                                                 generator=gen) * 0.01)
    acc = torch.zeros((N_SPARSE * VOCAB,), device="cuda")
    q_new, s_new = stochastic_quantize_rows(rows, ids=grads.ids, salt=salt)
    safe = torch.where(grads.mask > 0, grads.ids, N_SPARSE * VOCAB).to(torch.int32)

    def scatters():  # the step's two B4 launches: q rows, then scales
        scatter_set_rows(q_table, q_new, safe)
        scatter_set_rows(s_table.view(-1, 1), s_new.view(-1, 1), safe)

    parts["scatters_ms"] = float(np.median([time_cuda(scatters) for _ in range(3)]))
    for name, table, new in (("q", q_table, q_new), ("scale", s_table.view(-1, 1),
                                                       s_new.view(-1, 1))):
        print(f"classic update's {name} scatter-set launch: "
              f"{scatter_launch_info(table, new, safe.shape[0])}")
    parts["update_ms"] = float(np.median([time_cuda(
        lambda: classic_quantized_update(q_table, s_table, acc, ids, dvec, TRAIN_LR, word),
        iters=10, warmup=2) for _ in range(3)]))
    del q_table, s_table, acc
    print(f"stochastic_quantize_rows keyed at n={n} E={EMB}: kernel {med['ms']:.4f} ms, plain "
          f"(the torch hash, then the plain quantization) {med['plain_ms']:.4f} ms, bound "
          f"{keyed_bound['bound_ms']:.4f} ms ({keyed_bound['bytes'] / 1e6:.1f} MB: rows and ids "
          f"read, q and scale written), {100 * keyed_bound['bound_ms'] / med['ms']:.0f}% of the "
          f"bound; no single PyTorch call computes it; rounds {runs['ms']} / plain "
          f"{runs['plain_ms']}")
    print(f"stochastic_quantize_rows given bits at n={n} E={EMB}: kernel {med['given_ms']:.4f} "
          f"ms, plain {med['given_plain_ms']:.4f} ms, bound {given_bound['bound_ms']:.4f} ms "
          f"({given_bound['bytes'] / 1e6:.1f} MB), "
          f"{100 * given_bound['bound_ms'] / med['given_ms']:.0f}% of the bound; rounds "
          f"{runs['given_ms']}")
    print(f"classic update parts at n={n}: the id-keyed hash in torch (int64, to int32 "
          f"patterns), the pass the kernel replaces, {parts['hash_ms']:.4f} ms; dedup_row_grads "
          f"{parts['dedup_ms']:.4f} ms, the q and scale scatter-sets {parts['scatters_ms']:.4f} "
          f"ms, the whole classic_quantized_update of a [{N_SPARSE * VOCAB}, {EMB}] int8 table "
          f"{parts['update_ms']:.4f} ms; rounds {runs['hash_ms']} / {runs['dedup_ms']}")
    return err, timing, parts


@contextlib.contextmanager
def counting_hash():
    """Inside: every call of the torch id-keyed hash by the classic trainer
    is counted (``calls[0]``). At int8 with one scale a row B8 hashes the
    ids itself and the trainer calls it never; int4 and scale groups hash in
    torch."""
    calls = [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return id_keyed_rounding_bits(*args, **kwargs)

    with swapped(quantized_trainer_module, "id_keyed_rounding_bits", counted):
        yield calls


def check_no_torch_hash(label: str, calls: int) -> None:
    """Raises unless a classic int8 training run called the torch hash never."""
    if calls:
        raise AssertionError(f"[train {label}] the torch id-keyed hash ran {calls} times")
    print(f"[train {label}] the torch id-keyed hash ran 0 times: B8 hashes the ids itself")


def packed_from_classic(leaves: dict) -> np.ndarray:
    """``[V, 128]`` u8 packed rows holding the classic int8 leaves' q and
    scale, accumulator zero."""
    q, scale = leaves["unified_q"], leaves["unified_scale"]
    packed = np.zeros((q.shape[0], Q_W), np.uint8)
    packed[:, :EMB] = q.view(np.uint8)
    packed[:, EMB:EMB + 4] = scale[:, None].view(np.uint8)
    return packed


def classic_against_packed(rng: np.random.Generator, seed: int) -> str:
    """Phase 32: one classic step and one packed step of DCN-v2 at full
    width from the same weights and table, on a batch of 32768 rows whose
    ids are unique within each field: q and scale equal, accumulators rtol
    1e-6 (JAX's ``tests/test_quantized.py`` check; here it holds B8 against
    B3, which round alike)."""
    leaves = flax_leaves(rng, "classic")
    batch = make_train_batch(rng)
    for i in range(N_SPARSE):
        batch[f"c_{i}"] = rng.permutation(VOCAB)[:TRAIN_BATCH].astype(np.int32)
    packed_leaves = {k: v for k, v in leaves.items() if k != "unified_scale"}
    packed_leaves["unified_q"] = packed_from_classic(leaves)
    classic = make_trainer(DCNV2_SPEC, "classic", "cuda", leaves, batch, seed)
    before = counts()
    classic.train_step(batch)
    torch.cuda.synchronize()
    check_launches("[dcnv2] classic step", before, DCNV2_SPEC.per_step["classic"])
    got = (classic.model.unified_q.cpu(), classic.model.unified_scale.cpu(),
           classic.state.table_acc["unified"].cpu())
    del classic
    packed = make_trainer(DCNV2_SPEC, "int8", "cuda", packed_leaves, batch, seed)
    before = counts()
    packed.train_step(batch)
    torch.cuda.synchronize()
    check_launches("[dcnv2] packed step", before, DCNV2_SPEC.per_step["int8"])
    want = packed.unpacked_quantized()["unified"]
    del packed
    touched = torch.from_numpy(np.unique(unified_ids(batch)))
    q_off = int((got[0] != want[0]).sum())
    s_off = int((got[1].view(torch.int32) != want[1].view(torch.int32)).sum())
    if q_off or s_off or touched.shape[0] != TRAIN_BATCH * N_SPARSE:
        raise AssertionError(f"classic vs packed step: {q_off} q values and {s_off} scales "
                             f"differ")
    err = close(got[2], want[2], rtol=1e-6, atol=1e-8)
    moved = int((got[0][touched] != torch.from_numpy(leaves["unified_q"])[touched]).sum())
    note = (f"classic step vs packed step on {touched.shape[0]} unique ids: q and scale "
            f"bit-equal, accumulators max abs err {err:.3e}; {moved} q values moved")
    print(f"[dcnv2] {note}")
    return note


def fm_close(got: torch.Tensor, want: torch.Tensor, v: torch.Tensor) -> float:
    """FM forward, kernel against plain: max abs error; raises if any row is
    off by more than FM_ATOL + FM_RTOL * 0.5 * sum_e[(sum_f v)^2 + sum_f v^2]."""
    magnitude = 0.5 * (v.sum(dim=1).square() + v.square().sum(dim=1)).sum(dim=-1)
    err = (got - want).abs()
    if not bool((err <= FM_ATOL + FM_RTOL * magnitude).all()) or not torch.isfinite(got).all():
        raise AssertionError(f"fm_interaction mismatch: max abs err {float(err.max()):.3e} "
                             f"against a magnitude of {float(magnitude.max()):.3e}")
    return float(err.max())


def fm_inputs(gen: torch.Generator, rows: int):
    """Field vectors as the DeepFM path builds them: 26 sparse rows and 13
    dense value x factor vectors, all about N(0, 0.01); and an upstream
    gradient N(0, 1)."""
    v = torch.randn((rows, FM_FIELDS, EMB), device="cuda", generator=gen) * 0.01
    g = torch.randn((rows,), device="cuda", generator=gen)
    return v, g


def check_and_time_fm(gen: torch.Generator) -> dict:
    """Phase 12: both FM kernels against their plain versions at the rows
    the DeepFM path gives them, forward and backward through the Function
    against plain autograd at B=4096, then each kernel timed beside its
    plain version (CUDA events, median of 3 interleaved rounds) with its
    bound at the training batch. Returns the errors and timings."""
    errs = {"fwd": 0.0, "bwd": 0.0, "grad": 0.0}
    for (rows,) in FM_SHAPES:
        v, g = fm_inputs(gen, rows)
        fwd = fm_close(fm_interaction(v), fm_interaction_plain(v), v)
        bwd = close(fm_interaction_backward(v, g), fm_interaction_backward_plain(v, g),
                    rtol=FM_RTOL, atol=FM_ATOL)
        torch.cuda.synchronize()
        errs["fwd"], errs["bwd"] = max(errs["fwd"], fwd), max(errs["bwd"], bwd)
        print(f"fm kernels vs plain  [{rows}, {FM_FIELDS}, {EMB}]: forward max abs err "
              f"{fwd:.3e}, backward max abs err {bwd:.3e}")

    v, g = fm_inputs(gen, 4096)
    before = counts()
    leaf = v.clone().requires_grad_()
    out = fm_interaction(leaf)
    out.backward(g)
    torch.cuda.synchronize()
    check_launches("fm Function forward + backward", before,
                   {fm_interaction: 1, fm_interaction_backward: 1})
    plain = v.clone().requires_grad_()
    want = fm_interaction_plain(plain)
    want.backward(g)
    errs["grad"] = max(fm_close(out.detach(), want.detach(), v),
                       close(leaf.grad, plain.grad, rtol=FM_RTOL, atol=FM_ATOL))
    print(f"fm forward + backward through the Function vs plain autograd, B=4096: max abs err "
          f"{errs['grad']:.3e}")

    v, g = fm_inputs(gen, TRAIN_BATCH)
    runs = {k: [] for k in ("fwd", "fwd_plain", "bwd", "bwd_plain")}
    for _ in range(3):
        runs["fwd"].append(time_cuda(lambda: fm_interaction(v)))
        runs["fwd_plain"].append(time_cuda(lambda: fm_interaction_plain(v)))
        runs["bwd"].append(time_cuda(lambda: fm_interaction_backward(v, g)))
        runs["bwd_plain"].append(time_cuda(lambda: fm_interaction_backward_plain(v, g)))
    values = TRAIN_BATCH * FM_FIELDS * EMB
    timings = {}
    for kind, nbytes in (("fwd", 4 * (values + TRAIN_BATCH)),
                         ("bwd", 4 * (2 * values + TRAIN_BATCH))):
        ops_ms, bytes_ms = 1e3 * 3 * values / PEAK_F32_FLOPS, 1e3 * nbytes / PEAK_BYTES_S
        timings[kind] = {"ms": float(np.median(runs[kind])),
                         "plain_ms": float(np.median(runs[f"{kind}_plain"])),
                         "bound_ms": max(ops_ms, bytes_ms),
                         "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                         "library_ms": None}
        print(f"fm {kind} at [{TRAIN_BATCH}, {FM_FIELDS}, {EMB}]: kernel "
              f"{timings[kind]['ms']:.4f} ms, plain {timings[kind]['plain_ms']:.4f} ms, bound "
              f"{timings[kind]['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB); no single PyTorch "
              f"call computes it; rounds {runs[kind]} / plain {runs[kind + '_plain']}")
    return errs, timings


def check_and_time_lin_scan(rng: np.random.Generator, gen: torch.Generator) -> dict:
    """Phase 12, B2 at the DeepFM linear table's shape: E=1 read through a
    row stride of 64 (the staging column of ``[n, 64]`` packed rows under
    Adam, column 3), kernel against plain at bench ids and at 1 and 1000
    rows, its look-back's edges (``scan_edges``), then timed."""
    ids = unified_ids(make_train_batch(rng))
    _, heads, _ = segments(ids)
    wide = torch.randn((ids.shape[0], PACKED_W), device="cuda", generator=gen)
    x, heads = wide[:, 3:4], torch.from_numpy(heads).cuda()
    for rows in (ids.shape[0], 1, 1000):
        err = close(segmented_sum_scan(x[:rows], heads[:rows]),
                    segmented_sum_scan_plain(x[:rows], heads[:rows]), rtol=1e-5, atol=1e-5)
        print(f"segmented_sum_scan kernel vs plain  linear table n={rows:7d} E=1 row stride "
              f"{x.stride(0)}: max abs err {err:.3e}")
    scan_edges("linear table", x, heads)
    return time_seg_scan(x, heads)


# the pooling kernel against plain: (label, B, N, S, E, hidden, activation,
# spread inputs); the first three are DIN's shapes
DIN_POOL_CASES = (
    ("[1, 1]", 1, 1, DIN_STEPS, DIN_EMB, DIN_ATT, "sigmoid", False),
    ("[4096, 2]", DIN_BATCH, DIN_CAND, DIN_STEPS, DIN_EMB, DIN_ATT, "sigmoid", False),
    ("[1024, 100]", 1024, DIN_LOO, DIN_STEPS, DIN_EMB, DIN_ATT, "sigmoid", False),
    ("[4096, 2] spread", DIN_BATCH, DIN_CAND, DIN_STEPS, DIN_EMB, DIN_ATT, "sigmoid", True),
    ("[4096, 2] relu", DIN_BATCH, DIN_CAND, DIN_STEPS, DIN_EMB, DIN_ATT, "relu", True),
    ("E=8 (16, 8)", 1000, 3, 6, 8, (16, 8), "sigmoid", True),
    ("E=8 (8,)", 1000, 3, 6, 8, (8,), "sigmoid", True),
    ("E=8 (16, 8, 4) relu", 1000, 3, 6, 8, (16, 8, 4), "relu", True),
    ("E=8 (160, 40)", 1000, 3, 6, 8, (160, 40), "sigmoid", True),
    ("E=40", 1000, 3, DIN_STEPS, 40, DIN_ATT, "sigmoid", True),
    ("[37, 100] ragged", 37, DIN_LOO, DIN_STEPS, DIN_EMB, DIN_ATT, "sigmoid", False),
    ("S=129", 64, 3, 129, DIN_EMB, DIN_ATT, "relu", True),
    ("S=1 (160, 40)", 1000, 3, 1, 8, (160, 40), "sigmoid", True),  # 33 rows a tile, not 128
)


def din_pool_inputs(gen: torch.Generator, b: int, n: int, s: int, e: int, hidden, spread=False):
    """Pooling operands on the card: rows and weights N(0, 0.01), as DIN
    initialises them (``spread``: rows N(0, 1), weights N(0, 0.1), a peaked
    softmax); a fifth of the steps masked, step 0 always valid."""
    row, weight = (1.0, 0.1) if spread else (0.01, 0.01)
    his = torch.randn((b, s, e), device="cuda", generator=gen) * row
    tgt = torch.randn((b, n, e), device="cuda", generator=gen) * row
    valid = (torch.rand((b, s), device="cuda", generator=gen) < 0.8).to(torch.int32)
    valid[:, 0] = 1
    dims = [4 * e, *hidden, 1]
    params = []
    for i in range(len(dims) - 1):
        params += [torch.randn((dims[i], dims[i + 1]), device="cuda", generator=gen) * weight,
                   torch.randn((dims[i + 1],), device="cuda", generator=gen) * weight]
    return his, tgt, valid, params


def din_pool_work(b: int, n: int, s: int, e: int, hidden):
    """(least, split-form and concat-form operations, bytes) of the pooling.

    ``[h, t, h - t, h * t] w_0 = h (w_a + w_c) + t (w_b - w_c) + (h * t) w_d``
    exactly (``w_0``'s four row blocks), so the least work forms the two
    combined blocks once, runs the h part once a (b, s) and the t part once a
    (b, n), and for each (b, n, s) pair only ``h * t``, its product with
    ``w_d``, the sum of the three parts, the later layers and its share of the
    pool. The split form, which the kernel computes, runs the h part for
    every pair instead. The concat form runs all of ``w_0`` for every pair.
    Bytes: his, tgt, valid and the weights read once, the result written
    once."""
    dims = [4 * e, *hidden, 1]
    h1 = dims[1]
    later = sum(dims[i] * dims[i + 1] for i in range(1, len(dims) - 1))
    pairs = b * n * s
    combine = 2 * e * h1  # w_a + w_c and w_b - w_c
    t_part = 2 * e * h1 * b * n
    least = combine + t_part + 2 * e * h1 * b * s + pairs * (e + 2 * e * h1 + h1 + 2 * later + 2 * e)
    split = combine + t_part + pairs * (e + 4 * e * h1 + h1 + 2 * later + 2 * e)
    concat = pairs * 2 * (4 * e * h1 + later + e)
    weights = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
    return least, split, concat, 4 * (b * s * e + 2 * b * n * e + b * s + weights)


def check_and_time_din(gen: torch.Generator):
    """Phase 17, the pooling kernel: against plain at every case, forward and
    backward through its Function against plain autograd at the training
    shape, then kernel and plain timed (CUDA events, median of 3 interleaved
    rounds) with the bound (``din_pool_work``'s least work; the split form's,
    which the kernel runs, and the concat form's beside it) and the block's
    shared memory, at the training and the serving shape. Returns (max abs
    error at DIN's shapes, gradient error, timings)."""
    worst = 0.0
    for label, b, n, s, e, hidden, activation, spread in DIN_POOL_CASES:
        his, tgt, valid, params = din_pool_inputs(gen, b, n, s, e, hidden, spread)
        got = din_attention_pool(his, tgt, valid, params, activation)
        want = din_attention_pool_plain(his, tgt, valid, params, activation)
        torch.cuda.synchronize()
        err = close(got, want)
        print(f"din_attention_pool kernel vs plain  {label:22s} [{b}, {n}, {s}, {e}] {hidden} "
              f"{activation}: max abs err {err:.3e}")
        if label in ("[1, 1]", "[4096, 2]", "[1024, 100]"):
            worst = max(worst, err)

    # spread inputs: at the init's scale every gradient is under the atol
    his, tgt, valid, params = din_pool_inputs(gen, DIN_BATCH, DIN_CAND, DIN_STEPS, DIN_EMB,
                                              DIN_ATT, spread=True)
    upstream = torch.randn((DIN_BATCH, DIN_CAND, DIN_EMB), device="cuda", generator=gen)

    def forward_backward(fn):
        leaves = [t.clone().requires_grad_() for t in (his, tgt, *params)]
        out = fn(leaves[0], leaves[1], valid, leaves[2:])
        out.backward(upstream)
        return [out.detach()] + [t.grad for t in leaves]

    before = counts()
    got = forward_backward(din_attention_pool)
    torch.cuda.synchronize()
    check_launches("din_attention_pool Function forward + backward", before,
                   {din_attention_pool: 1})
    grad_err = max(close(a, b) for a, b in zip(got, forward_backward(din_attention_pool_plain)))
    print(f"din_attention_pool forward + backward through the Function vs plain autograd, "
          f"[{DIN_BATCH}, {DIN_CAND}, {DIN_STEPS}, {DIN_EMB}] spread: max abs err {grad_err:.3e} "
          f"(output, his, tgt and {len(params)} weights)")

    timings = {}
    tile = din_tile_plan(DIN_EMB, DIN_STEPS, DIN_ATT,
                         torch.cuda.get_device_properties(0).shared_memory_per_block_optin)
    for key, (b, n) in (("train", (DIN_BATCH, DIN_CAND)), ("serve", (1024, DIN_LOO))):
        his, tgt, valid, params = din_pool_inputs(gen, b, n, DIN_STEPS, DIN_EMB, DIN_ATT)
        runs = {"ms": [], "plain_ms": []}
        for _ in range(3):
            runs["ms"].append(time_cuda(lambda: din_attention_pool(his, tgt, valid, params),
                                        iters=20))
            runs["plain_ms"].append(time_cuda(
                lambda: din_attention_pool_plain(his, tgt, valid, params), iters=10))
        flops, split, concat, nbytes = din_pool_work(b, n, DIN_STEPS, DIN_EMB, DIN_ATT)
        ops_ms, bytes_ms = 1e3 * flops / PEAK_F32_FLOPS, 1e3 * nbytes / PEAK_BYTES_S
        # the kernels line takes the measured times and the bound only
        timings[key] = {k: float(np.median(v)) for k, v in runs.items()}
        ms = timings[key]["ms"]
        timings[key].update(bound_ms=max(ops_ms, bytes_ms), library_ms=None,
                            bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        print(f"din_attention_pool at [{b}, {n}, {DIN_STEPS}, {DIN_EMB}] {DIN_ATT}: kernel "
              f"{ms:.4f} ms, plain {timings[key]['plain_ms']:.4f} ms, bound "
              f"{timings[key]['bound_ms']:.4f} ms ({flops / 1e9:.3f} GFLOP, the least work, "
              f"{nbytes / 1e6:.1f} MB; {100 * timings[key]['bound_ms'] / ms:.1f}% of the "
              f"kernel's time); the split form the kernel runs {split / 1e9:.3f} GFLOP, "
              f"{1e3 * split / PEAK_F32_FLOPS:.4f} ms ({split / 1e9 / ms:.1f} TFLOP/s); the "
              f"concat form {concat / 1e9:.2f} GFLOP, {1e3 * concat / PEAK_F32_FLOPS:.4f} ms "
              f"({concat / 1e9 / ms:.1f} TFLOP/s at this time); {tile.rows} rows a tile, "
              f"{tile.smem_bytes} B of shared memory a block; no single PyTorch call computes "
              f"MLP-scored attention pooling; rounds {runs}")
    return worst, grad_err, timings


def check_and_time_din_update(rng: np.random.Generator, gen: torch.Generator) -> dict:
    """Phase 17, the update's kernels at DIN's step shape (the item table's
    90,112 ids of a batch, E=64): the scan over the f32 rows' staging columns
    (row stride 256) and the int8 rows' (row stride 96), the scatter of 1 KB
    f32 rows into ``[1048576, 256]`` and of 384-byte rows; each against
    plain (the scan also at its look-back's edges, ``scan_edges``), then
    timed (the requantization of DIN's rows is phase 9's)."""
    ids = din_item_ids(make_din_batch(rng))
    _, heads, _ = segments(ids)
    heads = torch.from_numpy(heads).cuda()
    timings = {}
    for kind, width, start in (("f32", DIN_PACKED_W, 3 * DIN_EMB),
                               ("int8", DIN_Q_W // 4, DIN_Q_BASE // 4)):
        wide = torch.randn((ids.shape[0], width), device="cuda", generator=gen)
        x = wide[:, start:start + DIN_EMB]
        err = close(segmented_sum_scan(x, heads), segmented_sum_scan_plain(x, heads), rtol=1e-5,
                    atol=1e-5)
        print(f"segmented_sum_scan kernel vs plain  DIN ids n={ids.shape[0]} E={DIN_EMB} row "
              f"stride {x.stride(0)}: max abs err {err:.3e}")
        scan_edges(f"DIN {kind} rows", x, heads)
        timings[f"scan_{kind}"] = time_seg_scan(x, heads)
        _, timings[f"scatter_{kind}"] = check_and_time_scatter(
            rng, gen, kind, ids=ids, vocab_rows=DIN_ITEMS, widths=(DIN_PACKED_W, DIN_Q_W))
    return timings


# B7 against plain: (label, B, V, D, tc, group, dtype); the serving shape first
B7_CASES = (
    ("serving shape bf16", B7_QUERIES, TT_ITEMS, TT_DIM, DEFAULT_TC, DEFAULT_GROUP,
     torch.bfloat16),
    ("serving shape f32", B7_QUERIES, TT_ITEMS, TT_DIM, DEFAULT_TC, DEFAULT_GROUP, torch.float32),
    ("B=1 bf16", 1, TT_ITEMS, TT_DIM, DEFAULT_TC, DEFAULT_GROUP, torch.bfloat16),
    ("B=37 D=16 bf16", 37, 1024, 16, 256, 2, torch.bfloat16),
    ("B=37 D=16 bf16", 37, 1000, 16, 256, 2, torch.bfloat16),
    ("B=37 D=16 bf16", 37, 700, 16, 256, 4, torch.bfloat16),
    ("B=37 D=16 f32", 37, 1024, 16, 256, 2, torch.float32),
    ("B=37 D=16 f32", 37, 1000, 16, 256, 2, torch.float32),
    ("B=37 D=16 f32", 37, 700, 16, 256, 4, torch.float32),
    ("V=1 bf16", 256, 1, TT_DIM, DEFAULT_TC, DEFAULT_GROUP, torch.bfloat16),
    ("V=100 bf16", 256, 100, TT_DIM, DEFAULT_TC, DEFAULT_GROUP, torch.bfloat16),
    ("V=100 f32", 256, 100, TT_DIM, DEFAULT_TC, DEFAULT_GROUP, torch.float32),
    # the bf16 kernel's edges: B past one 128-query tile, 5 and 300 tiles a
    # super-chunk (not a multiple of the TMA ring's depth; above 255), bf16
    # depths that are not a multiple of 8 (padded for TMA)
    ("B=200 bf16", 200, 5000, TT_DIM, 128, 3, torch.bfloat16),
    ("5 tiles bf16", 1, 5000, TT_DIM, 128, 5, torch.bfloat16),
    ("300 tiles bf16", 70, 100_000, 64, 38_400, 1, torch.bfloat16),
    ("300 tiles f32", 70, 100_000, 64, 38_400, 1, torch.float32),
    ("D=13 bf16", 33, 5000, 13, 256, 3, torch.bfloat16),
    ("D=100 bf16", 129, 3000, 100, 512, 2, torch.bfloat16),
)
B7_REQUEST_QUERIES = (1, 256)  # B7 also timed alone at the smaller fused requests


def unit_rows(gen: torch.Generator, n: int, d: int) -> torch.Tensor:
    """``[n, d]`` f32 rows of norm 1 on the card, as the normalized towers
    give them (scores are cosines)."""
    x = torch.randn((n, d), device="cuda", generator=gen)
    return x / x.norm(dim=1, keepdim=True)


def bin_margins(q: torch.Tensor, items: torch.Tensor, tc: int, group: int) -> torch.Tensor:
    """Each bin's best score minus its runner-up (inf where a bin has one
    candidate), from the plain version's f32 scores."""
    sup = tc * group
    qf = q.to(items.dtype).float()
    out = []
    for start in range(0, items.shape[0], sup):
        scores = qf @ items[start:start + sup].float().T
        scores = torch.nn.functional.pad(scores, (0, sup - scores.shape[1]), value=PAD_SCORE)
        scores = scores.reshape(q.shape[0], sup // LANES, LANES)
        if scores.shape[1] == 1:
            out.append(torch.full_like(scores[:, 0], float("inf")))
        else:
            top = scores.topk(2, dim=1).values
            out.append(top[:, 0] - top[:, 1])
    return torch.cat(out, dim=1)


def bins_agree(label: str, q, items, tc: int, group: int, got, want) -> float:
    """B7 against plain: vals rtol 1e-4 / atol 1e-6; idx equal wherever a
    bin's best and runner-up differ by more than that (elsewhere the ids
    must share the bin). Prints the exempt bins; returns the max abs
    error."""
    (gv, gi), (wv, wi) = got, want
    err = close(gv, wv)
    tied = bin_margins(q, items, tc, group) <= ATOL + RTOL * wv.abs()
    sup = tc * group
    if not torch.equal(gi[~tied], wi[~tied]) or not torch.equal(gi[tied] % LANES,
                                                                 wi[tied] % LANES) or (
            not torch.equal(gi[tied] // sup, wi[tied] // sup)):
        raise AssertionError(f"bin_max_scores {label}: ids differ outside near-tied bins")
    print(f"bin_max_scores kernel vs plain  {label:20s} B={q.shape[0]:5d} V={items.shape[0]:8d} "
          f"D={q.shape[1]:3d} tc={tc} group={group}: max abs err {err:.3e}, "
          f"{int((gi != wi).sum())} ids differ, {int(tied.sum())} of {tied.numel()} bins exempt "
          f"(best and runner-up within tolerance)")
    return err


def b7_work(b: int, v: int, d: int, dtype, tc: int = DEFAULT_TC,
            group: int = DEFAULT_GROUP) -> dict:
    """B7's bound: 2 B V D operations at the tensor cores' bf16 or the f32
    FMA rate; bytes: the f32 queries and the items read once, the outputs
    written once."""
    n_super = -(-v // (tc * group))
    item_bytes = 2 if dtype == torch.bfloat16 else 4
    nbytes = 4 * b * d + item_bytes * v * d + 8 * b * n_super * LANES
    peak = PEAK_BF16_TENSOR_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    ops_ms, bytes_ms = 1e3 * 2 * b * v * d / peak, 1e3 * nbytes / PEAK_BYTES_S
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def duplicated_rows_exempt(q, items, got_idx, want_idx, dtype) -> int:
    """The bins of B7's duplicated-rows case whose ids differ: each must pick
    two distinct rows (no copy of the other) whose scores agree within rtol
    1e-4 / atol 1e-6, the near tie ``bins_agree`` allows in the other cases;
    returns how many there are."""
    differ = got_idx != want_idx
    if not bool(differ.any()):
        return 0
    rows = torch.nonzero(differ)[:, 0]
    got, want = got_idx[differ].long(), want_idx[differ].long()
    if bool((items[got] == items[want]).all(dim=1).any()):
        raise AssertionError(f"bin_max_scores duplicated rows {dtype}: two copies of one row "
                             f"took different ids")
    qd = q[rows].to(dtype).float()
    got_s = (qd * items[got].float()).sum(dim=1)
    want_s = (qd * items[want].float()).sum(dim=1)
    try:
        close(got_s, want_s)
    except AssertionError as fault:
        raise AssertionError(f"bin_max_scores duplicated rows {dtype}: ids differ where the "
                             f"scores do not tie: {fault}") from None
    return int(differ.sum())


def check_and_time_b7(gen: torch.Generator):
    """Phase 22: B7 against plain at every case of ``B7_CASES`` and with
    duplicated rows (``items[i] == items[i + 128]``: the lower id wins),
    then kernel, plain, the per-super-chunk cuBLAS score GEMMs alone (f32
    out, no selection) and the exact chunked top-k timed at the serving
    shape (CUDA events, median of 3 interleaved rounds; the plain version,
    4.6 s a call there, in the first round only) beside both bounds.
    Returns (max abs error at the serving shape, timings by dtype)."""
    worst = 0.0
    main = {}
    for label, b, v, d, tc, group, dtype in B7_CASES:
        q = unit_rows(gen, b, d)
        items = unit_rows(gen, v, d).to(dtype)
        got = bin_max_scores(q, items, tc, group)
        want = bin_max_scores_plain(q, items, tc, group)
        torch.cuda.synchronize()
        err = bins_agree(label, q, items, tc, group, got, want)
        if label.startswith("serving shape"):
            worst = max(worst, err)
            main[dtype] = (q, items)
        del got, want
    q, items = unit_rows(gen, 512, 64), unit_rows(gen, 70_000, 64)
    for dtype in (torch.bfloat16, torch.float32):
        dup = items.to(dtype, copy=True)
        dup[128:256] = dup[:128]
        dup[20_000 + 128] = dup[20_000]
        got_vals, got_idx = bin_max_scores(q, dup, 2048, 4)
        want_vals, want_idx = bin_max_scores_plain(q, dup, 2048, 4)
        close(got_vals, want_vals)
        if bool(((got_idx // 128 == 1) | (got_idx == 20_000 + 128)).any()):
            raise AssertionError(f"bin_max_scores duplicated rows {dtype}: a copy won a tie")
        exempt = duplicated_rows_exempt(q, dup, got_idx, want_idx, dtype)
        print(f"bin_max_scores kernel vs plain  duplicated rows {str(dtype):14s}: no copy won; "
              f"ids equal but in {exempt} of {got_idx.numel()} bins (two distinct rows whose "
              f"scores agree within rtol {RTOL} / atol {ATOL})")

    timings = {}
    sup = DEFAULT_TC * DEFAULT_GROUP
    for dtype, (q, items) in main.items():
        b, d = q.shape
        v = items.shape[0]
        q_cast = q.to(dtype)

        def library():  # cuBLAS score GEMMs, f32 out, never called by the port
            for start in range(0, v, sup):
                chunk = items[start:start + sup]
                if dtype == torch.bfloat16:
                    torch.mm(q_cast, chunk.T, out_dtype=torch.float32)
                else:
                    torch.mm(q_cast, chunk.T)

        runs = {"ms": [], "plain_ms": [], "library_ms": []}
        for round_ in range(3):
            runs["ms"].append(time_cuda(lambda: bin_max_scores(q, items), iters=10, warmup=2))
            if round_ == 0:  # 4.6 s a call at the serving shape: one round
                runs["plain_ms"].append(time_cuda(lambda: bin_max_scores_plain(q, items),
                                                  iters=1, warmup=0))
            runs["library_ms"].append(time_cuda(library, iters=10, warmup=2))
        timing = {k: float(np.median(r)) for k, r in runs.items()}
        work = b7_work(b, v, d, dtype)
        timing.update(bound_ms=work["bound_ms"], bound_by=work["bound_by"])
        if dtype == torch.bfloat16:
            exact = [time_cuda(lambda: retrieval_module._topk_scores(q, items, TT_K), iters=3,
                               warmup=1) for _ in range(3)]
            timing["exact_topk_ms"] = float(np.median(exact))
            timing["f32_fma_bound_ms"] = b7_work(b, v, d, torch.float32)["ops_ms"]
            # B7 alone at the smaller fused requests: one unit a (128-query
            # tile, super-chunk), so few units for 132 SMs
            timing["requests"] = {}
            for n in B7_REQUEST_QUERIES:
                qn = q[:n].contiguous()
                ms = float(np.median([time_cuda(lambda: bin_max_scores(qn, items), iters=10,
                                                warmup=2) for _ in range(3)]))
                units = -(-n // 128) * -(-v // sup)
                timing["requests"][n] = {"ms": ms, "units": units,
                                         "bound_ms": b7_work(n, v, d, dtype)["bound_ms"]}
        timings[dtype] = timing
        print(f"bin_max_scores at [{b}, {d}] x [{v}, {d}] {dtype}: kernel {timing['ms']:.4f} ms "
              f"({2e-9 * b * v * d / timing['ms']:.1f} TFLOP/s), plain {timing['plain_ms']:.4f} ms, "
              f"cuBLAS score GEMMs alone {timing['library_ms']:.4f} ms, bound "
              f"{timing['bound_ms']:.4f} ms ({timing['bound_by']}: "
              + ("bf16 tensor cores" if dtype == torch.bfloat16 else "f32 FMA")
              + f"; bytes {work['bytes_ms']:.4f} ms)"
              + (f", the f32 FMA bound {timing['f32_fma_bound_ms']:.4f} ms, exact chunked top-k "
                 f"{timing['exact_topk_ms']:.3f} ms; alone at "
                 + ", ".join(f"B={n}: {r['ms']:.4f} ms ({r['units']} units for 132 SMs, bound "
                             f"{r['bound_ms']:.4f} ms)" for n, r in timing["requests"].items())
                 if dtype == torch.bfloat16 else "")
              + f"; rounds {runs}")
    return worst, timings


def retrieval_agree(label: str, got, want, rtol: float = 1e-4, atol: float = 1e-5) -> float:
    """Two top-k results of one request: scores rtol 1e-4 / atol 1e-5 (f32
    sums in another order, divided by the temperature) position by position;
    an id missing from the other result only where its score ties the k-th
    (within the same tolerance). Returns the max abs error."""
    (gs, gi), (ws, wi) = ((s.float().cpu(), i.cpu()) for s, i in (got, want))
    err = close(gs, ws, rtol=rtol, atol=atol)
    missing = ~(gi[:, :, None] == wi[:, None, :]).any(dim=-1)
    kth = ws[:, -1:]
    at_edge = (gs - kth).abs() <= atol + rtol * kth.abs()
    if bool((missing & ~at_edge).any()):
        raise AssertionError(f"{label}: {int((missing & ~at_edge).sum())} ids differ away from "
                             f"the k-th score")
    print(f"{label}: scores max abs err {err:.3e}; {int((gi != wi).sum())} of {gi.numel()} ids at "
          f"other positions, {int(missing.sum())} swapped at the k-th score")
    return err


def scores_exact(label: str, model, index: torch.Tensor, u_ids, scores, ids) -> float:
    """The returned scores against the exact f32 scores of the returned ids
    (the query cast to the index's dtype, then f32 products and sums):
    rtol 1e-4 / atol 1e-5."""
    with torch.inference_mode():
        u_vec = model.user_vectors(torch.as_tensor(u_ids).cuda()).to(index.dtype).float()
        exact = torch.einsum("bd,bkd->bk", u_vec, index[ids.long()].float()) / model.temperature
    err = close(scores, exact, rtol=1e-4, atol=1e-5)
    print(f"{label}: returned scores vs the exact f32 scores of the returned ids, max abs err "
          f"{err:.3e}")
    return err


def recall_at_k(got_ids: torch.Tensor, exact_ids: torch.Tensor) -> float:
    return float((got_ids[:, :, None] == exact_ids[:, None, :]).any(dim=-1).float().mean())


def serve_two_tower(seed: int) -> dict:
    """Phase 23: two-tower retrieval at ``scripts/retrieval_bench.py``'s
    scale with the f32 item table (bf16 and f32 index) and with the int8
    ``i_q`` (index built through dequantization). Fused requests of 1, 256
    and 4096 queries at k=100 each launch B7 once and agree with the same
    request through the plain version on the card (the 256-query one also
    on the CPU); their scores are the exact scores of their ids; the
    4096-query request's recall against the exact path is at least 0.975.
    Then ``approx=True`` (the exact path), point-wise and candidate scoring
    through ``make_serving_fn`` (no B7), and a profile of the 4096-query
    request. Each retrieve function captures a CUDA graph a request shape
    at its second request and replays it after: the warm-up runs each
    request twice, and the timed and profiled requests are replays. The
    plain comparisons run through a retrieve function made inside the swap,
    whose first request of a shape runs eagerly (the plain version), with no
    kernel launched. The caller zeroes the counts. Returns the
    measurements."""
    out = {"fused_ms": {}, "recall": {}, "index_build_ms": {}, "fused_calls": 0}
    rng = np.random.default_rng(seed + 9)
    theory = 1 - (TT_K - 1) / (2 * -(-TT_ITEMS // (DEFAULT_TC * DEFAULT_GROUP)) * LANES)
    requests = {n: rng.integers(0, TT_USERS, size=n).astype(np.int32) for n in TT_REQUESTS}
    for table in ("f32", "int8"):
        tag = f"[two_tower {table}]"
        leaves = tt_leaves(rng, table)
        model = params_from_jax(leaves, make_two_tower(table, "cuda", seed))
        build = []
        for _ in range(2):  # the first also warms cuBLAS up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            index = build_item_index(model, TT_ITEMS, batch_size=TT_INDEX_BATCH)
            torch.cuda.synchronize()
            build.append(1e3 * (time.perf_counter() - t0))
        out["index_build_ms"][table] = build[-1]
        print(f"{tag} build_item_index({TT_ITEMS}, batch_size={TT_INDEX_BATCH}): {index.dtype} "
              f"{tuple(index.shape)}, {index.nbytes / 1e6:.1f} MB, {build[0]:.1f} ms (first), "
              f"{build[1]:.1f} ms")
        fused = make_retrieve_fn(model, approx="fused")
        fused32 = make_retrieve_fn(model, approx="fused")  # the f32 index's graphs

        def request(label, n, fn=fused, idx=index):
            before = counts()
            result = fn(idx, requests[n], TT_K)
            torch.cuda.synchronize()
            fused_path = fn is fused or fn is fused32
            check_launches(f"{tag} {label}", before, {bin_max_scores: 1} if fused_path else {})
            out["fused_calls"] += fused_path
            scores, ids = result
            if (tuple(ids.shape) != (n, TT_K) or not torch.isfinite(scores).all()
                    or int(ids.min()) < 0 or int(ids.max()) >= TT_ITEMS):
                raise AssertionError(f"{tag} {label}: ids {tuple(ids.shape)} out of shape or range")
            return result

        results = {}
        for n in TT_REQUESTS:
            request(f"warm-up {n}", n)
            request(f"capture {n}", n)
            times = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                results[n] = request(f"fused {n} queries", n)
                times.append(1e3 * (time.perf_counter() - t0))
            out["fused_ms"][f"{table} {n}"] = float(np.median(times))
            print(f"{tag} fused request of {n:4d} queries, k={TT_K}: median "
                  f"{np.median(times):8.3f} ms, min {min(times):8.3f} ms (host clock, {REPEATS} "
                  f"captured requests)")

        def plain_request(label, n, idx):
            """A fused request through the plain bin max: a retrieve function
            made inside the swap, whose first request of a shape is eager."""
            with swapped(retrieval_module, "bin_max_scores", bin_max_scores_plain):
                return request(label, n, fn=make_retrieve_fn(model, approx="fused"), idx=idx)

        for n in TT_REQUESTS:
            retrieval_agree(f"{tag} fused {n} queries, kernel vs plain on the card (no kernel "
                            f"launched in the plain run)", results[n],
                            plain_request(f"plain {n}", n, index))
        for n in TT_REQUESTS:
            scores_exact(f"{tag} fused {n} queries", model, index, requests[n], *results[n])

        exact = make_retrieve_fn(model)
        t0 = time.perf_counter()
        exact_result = request("exact 4096 queries", 4096, fn=exact)
        exact_ms = 1e3 * (time.perf_counter() - t0)
        recall = recall_at_k(results[4096][1], exact_result[1])
        out["recall"][table] = recall
        print(f"{tag} recall@{TT_K} of the fused 4096-query request against the exact path: "
              f"{recall:.5f} (theory 1 - (k-1)/(2 n_bins) = {theory:.5f}; exact path "
              f"{exact_ms:.1f} ms)")
        if recall < TT_RECALL_MIN:
            raise AssertionError(f"{tag} recall {recall:.5f} below {TT_RECALL_MIN}")
        approx = request("approx=True 256 queries", 256, fn=make_retrieve_fn(model, approx=True))
        retrieval_agree(f"{tag} approx=True (the exact path) vs exact, 256 queries", approx,
                        exact(index, requests[256], TT_K))

        if table == "f32":
            out["exact_ms"] = exact_ms
            cpu_model = params_from_jax(leaves, make_two_tower(table, "cpu", seed))
            with torch.inference_mode():
                cpu_rows = cpu_model.item_vectors(torch.arange(4096)).to(torch.bfloat16).float()
            card_rows = index[:4096].float().cpu()
            ulp = torch.finfo(torch.bfloat16).eps * card_rows.abs()
            if not bool(((cpu_rows - card_rows).abs() <= ulp).all()):
                raise AssertionError(f"{tag} index rows differ from the CPU's by more than an ulp")
            cpu_result = make_retrieve_fn(cpu_model, approx="fused")(
                index.cpu(), requests[TT_CPU_REQUEST], TT_K)
            retrieval_agree(f"{tag} fused {TT_CPU_REQUEST} queries, card vs CPU (plain) port",
                            results[TT_CPU_REQUEST], cpu_result)
            del cpu_model
            index32 = build_item_index(model, TT_ITEMS, batch_size=TT_INDEX_BATCH,
                                       dtype=torch.float32)
            result32 = request("fused 256 queries, f32 index", 256, fn=fused32, idx=index32)
            scores_exact(f"{tag} fused 256 queries on the f32 index", model, index32,
                         requests[256], *result32)
            retrieval_agree(f"{tag} fused 256 queries on the f32 index, kernel vs plain",
                            result32, plain_request("plain 256, f32 index", 256, index32))
            fused32.graphs.clear()  # its graphs hold index32
            del index32
            profile_call(lambda: fused(index, requests[4096], TT_K),
                         f"{tag} fused 4096-query request", {bin_max_scores: 1}, top=8)
            out["fused_calls"] += 1

        serve = Trainer(model).make_serving_fn()
        for shape in ((1,), (1000,), (4096,), (256, 100)):
            req = {"uid": rng.integers(0, TT_USERS, shape[0]).astype(np.int32),
                   "iid": rng.integers(0, TT_ITEMS, shape).astype(np.int32)}
            before = counts()
            got = serve(req)
            torch.cuda.synchronize()
            check_launches(f"{tag} make_serving_fn {shape}", before, {})
            if tuple(got.shape) != shape or not torch.isfinite(got).all():
                raise AssertionError(f"{tag} make_serving_fn {shape}: {tuple(got.shape)}")
        print(f"{tag} make_serving_fn point-wise [1|1000|4096] and candidates [256, 100]: finite "
              f"scores, no B7 launch")
        # the retrieve functions' graphs hold the 256 MB index: drop them too
        del model, index, leaves, fused, exact, fused32
        torch.cuda.empty_cache()
    return out


def make_trainer(spec: ModelSpec, table: str, device: str, leaves: dict, sample: dict,
                 seed: int, metrics=("ndcg@10", "hit@10"), table_optimizer: str = "adam",
                 matmul_precision: Optional[str] = None, optimizer: str = "adam",
                 **optimizer_kwargs):
    """bench.py's training set-up for ``table``: f32, packed ``table || m || v``
    rows under lazy Adam (``SparseEmbeddingTrainer``; DeepFM's linear table
    too); int8, packed ``q || scale || acc`` rows under rowwise Adagrad with
    stochastic requantization (``QuantizedEmbeddingTrainer``; DeepFM's f32
    linear table in the dense optimizer); a classic format, the same with
    the model's ``unified_q`` and ``unified_scale`` buffers and the state's
    accumulator (``packed_tables=False``); another of ``SPARSE_FORMATS``,
    the sparse trainer with its arguments and ``table_optimizer`` (phase
    41). The dense ``optimizer`` (Adam; phase 42 also adagrad, adamw and a
    global-norm clip, through ``optimizer_kwargs``), the spec's loss and lr
    (BCE and 1e-3 but for the two-tower model); weights from ``leaves``
    (flax layout); ``metrics`` for ``evaluate``."""
    model = spec.make(table, device, seed)
    if spec.trainer is not None:
        trainer = spec.trainer(model, table, device)
    elif table in SPARSE_FORMATS:
        trainer = SparseEmbeddingTrainer(model, device=device, table_optimizer=table_optimizer,
                                         **SPARSE_FORMATS[table])
    else:
        trainer = QuantizedEmbeddingTrainer(model, device=device,
                                            packed_tables=table not in CLASSIC)
    trainer.compile(optimizer=optimizer, lr=spec.lr, loss=spec.loss, metrics=metrics,
                    matmul_precision=matmul_precision, **optimizer_kwargs)
    trainer.init_state(sample, seed=seed)
    return params_from_jax(leaves, trainer)


def trained_tables(trainer) -> dict:
    """The tables a trainer updates in place, by name: each packed buffer;
    for a classic table its ``q`` and ``scale`` buffers and its
    accumulator; an unpacked table and its moments (none for the dense
    ``RLTrainer``)."""
    tables = dict(getattr(trainer.state, "packed", {}))
    for path, moments in getattr(trainer.state, "table_moments", {}).items():
        if moments:
            tables[path] = trainer.model.get_parameter(path.replace("/", "."))
            tables.update({f"{path} {key}": t for key, t in moments.items()})
    for name, acc in getattr(trainer.state, "table_acc", {}).items():
        info = trainer._specs[name]
        for path in (info["q_path"], info["scale_path"]):
            tables[path] = trainer.model.get_buffer(path)
        tables[f"{name} accumulator"] = acc
    return tables


def time_table_share(trainer, batch: dict, path: str) -> float:
    """One packed f32 table's own share of a step: its gather at the batch's
    ids and its packed update (lazy Adam), on a copy of its buffer with
    N(0, 1e-3) grads; CUDA events, median of 3 rounds of 10. These launches
    are not the main path's."""
    spec = next(s for s in trainer.model.sharded_table_specs(batch).values() if s["path"] == path)
    ids = spec["ids"].reshape(-1).to(torch.int32)
    buffer = trainer.state.packed[path].clone()
    dvec = torch.randn((ids.shape[0], trainer._emb_dims[path]), device="cuda") * 1e-3

    def share():
        rows = buffer.index_select(0, ids)
        packed_sparse_update(buffer, rows, ids, dvec, 1, TRAIN_LR, "adam")

    ms = float(np.median([time_cuda(share, iters=10, warmup=2) for _ in range(3)]))
    del buffer
    return ms


def train(spec: ModelSpec, table: str, leaves: dict, rng: np.random.Generator, seed: int,
          table_shares: bool = False):
    """Phases 7, 10, 14, 15, 19, 20, 24, 25, 29, 30 and 33: one main training
    path, every launch count from zero. Returns the launches (by kernel
    name), the ms/step and, with ``table_shares``, each packed f32 table's
    own share of a step in ms."""
    tag = f"[train {spec.name} {table}]"
    per_step = spec.per_step[table]
    rows = spec.train_rows
    host = [spec.batch(rng, rows) for _ in range(4)]
    trainer = make_trainer(spec, table, "cuda", leaves, host[0], seed)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()} for b in host]
    if table == "int8" and spec.table_lr is not None and trainer._table_lr != spec.table_lr:
        raise AssertionError(f"{tag} table lr {trainer._table_lr}, want {spec.table_lr}")
    addresses = {path: t.data_ptr() for path, t in trained_tables(trainer).items()}
    for path, t in trained_tables(trainer).items():
        print(f"{tag} table {path} {tuple(t.shape)} {t.dtype}, {t.nbytes / 1e6:.1f} MB")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def check_buffers():
        for path, t in trained_tables(trainer).items():
            if t.data_ptr() != addresses[path]:
                raise AssertionError(f"{tag} the table {path} was reallocated")
        q_path = spec.tables["int8"]
        if table == "int8" and trainer.model.get_buffer(q_path).data_ptr() != addresses[q_path]:
            raise AssertionError(f"{tag} the packed table is not the model's {q_path}")

    zero_counts()
    zero = counts()
    losses = []
    steps = TRAIN_WARMUP + TRAIN_TIMED
    for step in range(steps):
        if step == TRAIN_WARMUP:
            torch.cuda.synchronize()
            start.record()
            t0 = time.perf_counter()
        losses.append(trainer.train_step(batches[step % len(batches)]))
    end.record()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / TRAIN_TIMED
    check_launches(f"{tag} {steps} train steps", zero, {k: n * steps for k, n in per_step.items()})
    losses = torch.stack(losses).cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"{tag} non-finite losses {losses.tolist()}")
    check_buffers()
    ms = start.elapsed_time(end) / TRAIN_TIMED
    print(f"{tag} {steps} train_steps, launches {names(counts())}; losses {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}")
    print(f"{tag} {ms:.3f} ms/step (CUDA events over {TRAIN_TIMED} steps), "
          f"{rows / (ms / 1e3):.0f} examples/s; host clock {host_ms:.3f} ms/step")
    print(f"{tag} peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    before = counts()
    history = trainer.fit_steps(iter(batches), steps=4, log_every=2)
    check_launches(f"{tag} fit_steps(4)", before, {k: 4 * n for k, n in per_step.items()})
    if len(history.history["loss"]) != 2 or not np.isfinite(history.history["loss"]).all():
        raise AssertionError(f"{tag} fit_steps: history {history.history}")
    print(f"{tag} fit_steps(4, log_every=2): loss {history.history['loss']}")
    profile_call(lambda: trainer.train_step(batches[0]), f"{tag} one step", per_step, top=24,
                 host_top=12)
    check_buffers()

    before = counts()
    request = {k: v[:1000] for k, v in host[1].items() if k != "label"}
    scores = trainer.make_serving_fn()(request)
    torch.cuda.synchronize()
    check_launches(f"{tag} serving from the trained state", before,
                   {spec.forward_kernel: 1} if spec.forward_kernel else {})
    shape = tuple(request[spec.scored_key].shape)
    if tuple(scores.shape) != shape or not torch.isfinite(scores).all():
        raise AssertionError(f"{tag} serving from the trained state failed")
    print(f"{tag} make_serving_fn on the trained state: {shape} finite scores, mean "
          f"{float(scores.mean()):.6f}")
    if table == "int8":
        path, name = spec.tables["int8"], spec.q_name
        touched = torch.from_numpy(np.unique(np.concatenate(
            [spec.table_ids(path, b) for b in host])))
        _, _, acc = trainer.unpacked_quantized()[name]
        if not bool((acc[touched] > 0).all()) or acc.numel() != trainer.state.packed[path].shape[0]:
            raise AssertionError(f"{tag} unpacked_quantized: an accumulator of a touched row "
                                 f"stayed 0")
        print(f"{tag} unpacked_quantized: acc > 0 on all {touched.shape[0]} touched rows, "
              f"{int((acc > 0).sum())} of {acc.numel()} rows")
    elif table in CLASSIC:
        touched = torch.from_numpy(np.unique(np.concatenate(
            [spec.table_ids(spec.tables[table], b) for b in host]))).cuda()
        acc = trainer.state.table_acc[spec.q_name]
        if not bool((acc[touched] > 0).all()):
            raise AssertionError(f"{tag} an accumulator of a touched row stayed 0")
        print(f"{tag} table_acc: acc > 0 on all {touched.shape[0]} touched rows, "
              f"{int((acc > 0).sum())} of {acc.numel()} rows")
    if spec.after_train is not None:
        spec.after_train(trainer, host, tag)
    launches = names(counts())
    shares = {}
    if table_shares:
        for path in trainer.state.packed:
            shares[path] = time_table_share(trainer, batches[0], path)
        print(f"{tag} each table's own share of a step (gather + packed update, timed "
              f"alone): {shares} ms")
    return launches, ms, shares


def int8_rows_agree(tag: str, path: str, card, cpu, emb: int) -> str:
    """Int8 rows, card against CPU: packed rows, or classic ``(q, scale,
    acc)`` triples; scale and accumulator rtol 1e-4 / atol 1e-6, q values
    off by at most one in at most 0.1% of them (f32 sums in another order
    move a value over a rounding threshold)."""
    (cq, cs, ca), (pq, ps, pa) = (r if isinstance(r, tuple) else unpack_quantized_table(r, emb)
                                  for r in (card, cpu))
    err = max(close(cs, ps), close(ca, pa))
    diff = (cq.int() - pq.int()).abs()
    flips = int((diff > 0).sum())
    if int(diff.max()) > 1 or flips > max(1, diff.numel() // 1000):
        raise AssertionError(f"{tag} int8 card vs CPU: {flips} q values differ, by up to "
                             f"{int(diff.max())}")
    return f"{path} scale/acc {err:.3e}, {flips} of {diff.numel()} q values off by one"


def card_against_cpu(spec: ModelSpec, table: str, leaves: dict, rng: np.random.Generator,
                     seed: int) -> None:
    """Phases 8, 11, 16 and 31: 2 steps at batch 1024 on the card and on the
    CPU (plain versions) from the same state:
    losses rtol 1e-5, dense parameters
    rtol 1e-4 / atol 1e-6 (DeepFM's int8 set-up keeps its linear table
    there, whose card gradient sums by atomics in no fixed order); each
    packed table's touched rows rtol 1e-4 / atol 1e-6 (f32), or their scale
    and accumulator so and their q values off by at most one in at most 0.1%
    of them (int8, packed or classic: f32 sums in another order move a value
    over a rounding threshold)."""
    tag = f"[{spec.name} {table}]"
    batch_rows, emb = spec.cpu_rows, spec.emb
    host = [spec.batch(rng, batch_rows) for _ in range(CPU_STEPS)]
    runs = {}
    for device in ("cuda", "cpu"):
        trainer = make_trainer(spec, table, device, leaves, host[0], seed)
        losses = torch.stack([trainer.train_step(b) for b in host]).cpu()
        keys = {path.replace("/", ".") for path in trained_tables(trainer)}
        dense = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()
                 if k not in keys}
        rows = {}
        for path, packed in trainer.state.packed.items():
            touched = np.unique(np.concatenate([spec.table_ids(path, b) for b in host]))
            rows[path] = packed[torch.from_numpy(touched).to(device)].cpu()
        for name, acc in getattr(trainer.state, "table_acc", {}).items():
            info = trainer._specs[name]
            touched = np.unique(np.concatenate([spec.table_ids(info["q_path"], b) for b in host]))
            index = torch.from_numpy(touched).to(device)
            rows[info["q_path"]] = tuple(
                t[index].cpu() for t in (trainer.model.get_buffer(info["q_path"]),
                                         trainer.model.get_buffer(info["scale_path"]), acc))
        runs[device] = losses, dense, rows
        del trainer
    (card_loss, card_dense, card_rows), (cpu_loss, cpu_dense, cpu_rows) = runs["cuda"], runs["cpu"]
    loss_err = close(card_loss, cpu_loss, rtol=1e-5, atol=0.0)
    dense_err = max(close(card_dense[k], cpu_dense[k]) for k in cpu_dense)
    notes = []
    for path, cpu in cpu_rows.items():
        if table == "f32" or path != spec.tables[table]:
            notes.append(f"{path} {close(card_rows[path], cpu):.3e} ({cpu.shape[0]} rows)")
            continue
        notes.append(int8_rows_agree(tag, path, card_rows[path], cpu, emb))
    print(f"{tag} card vs CPU, {CPU_STEPS} steps at batch {batch_rows}: losses "
          f"{card_loss.tolist()} / {cpu_loss.tolist()}; max abs err: loss {loss_err:.3e}, dense "
          f"params {dense_err:.3e}; touched packed rows: {'; '.join(notes)}")


def adam_values_agree(label: str, got: torch.Tensor, want: torch.Tensor, v_hat: torch.Tensor,
                      lr: float):
    """Adam-updated values, card against CPU after one step from a common
    state: rtol 1e-4 / atol 1e-6, except where the CPU's bias-corrected RMS
    gradient ``sqrt(v_hat)`` is under ``ADAM_EPS_WINDOW``: there the step
    ``lr * m_hat / (sqrt(v_hat) + eps)`` turns the last bits of a gradient that
    summed to nearly nothing into a share of ``lr``, so those values need only
    lie within two steps (2.01 lr) of each other. Returns (max abs error of the
    others, how many values in the window differ)."""
    ill = v_hat.sqrt() < ADAM_EPS_WINDOW
    err = close(got[~ill], want[~ill]) if bool((~ill).any()) else 0.0
    if bool(((got[ill] - want[ill]).abs() > 2.01 * lr).any()):
        raise AssertionError(f"{label}: a value in the eps window moved more than two steps")
    return err, int((got[ill] != want[ill]).sum())


def bf16_values_agree(label: str, got: torch.Tensor, want: torch.Tensor, v_hat: torch.Tensor,
                      lr: float):
    """bf16 ``table || m || v`` columns, card against CPU after one step from
    a common state: each value within one bf16 ulp of the CPU's (the f32
    arithmetic's last bits may round the other way) or within ``ATOL`` (as
    the f32 check holds the moments: a gradient that cancels to 0 on one
    side leaves a moment of 1e-16 on the other), or, for a table value in
    Adam's eps window (``adam_values_agree``), within two steps (2.01 lr).
    Returns (values one ulp apart, window values that differ)."""
    g, w = got.float(), want.float()
    _, exponent = torch.frexp(w)
    ulp = torch.where(w == 0, 0.0, torch.ldexp(torch.ones_like(w), exponent - 8))
    ulp = torch.clamp(ulp, min=ATOL)
    diff = (g - w).abs()
    emb = v_hat.shape[1]
    ill = torch.zeros_like(w, dtype=torch.bool)
    ill[:, :emb] = v_hat.sqrt() < ADAM_EPS_WINDOW
    bad = (diff > ulp) & ~(ill & (diff <= 2.01 * lr))
    if bool(bad.any()):
        raise AssertionError(f"{label}: {int(bad.sum())} bf16 values more than one ulp from the "
                             f"CPU's, max abs err {float(diff[bad].max()):.3e}")
    return int(((diff > 0) & ~ill).sum()), int(((diff > 0) & ill).sum())


def stepped_card_against_cpu(spec: ModelSpec, table: str, leaves: dict,
                             rng: np.random.Generator, seed: int, **compiled) -> None:
    """Phases 21, 26 and 41: the spec's 2 steps at its CPU batch (512 for DIN,
    the two-tower model and phase 41) on the card and on the CPU (plain
    versions), each step from a common state: after step 1 the card's
    trainer takes the CPU's tables, moments and dense optimizer state.
    Checked after every step: the loss rtol 1e-5; the packed moments, an
    unpacked table's moments, the int8 rows (``int8_rows_agree``) and every
    Adam-updated value rtol 1e-4 / atol 1e-6 (``adam_values_agree``: values
    whose gradient sits in Adam's eps window are counted and bounded
    instead); bf16 rows within one bf16 ulp or atol 1e-6
    (``bf16_values_agree``); the dense moments as ``MOMENT_CHECKS`` says,
    which holds each gradient, in the eps window too, to rtol 1e-4 /
    ``GRAD_ATOL``. Stepping from a common state keeps one such value's
    rounding from steering the next step: run freely, two correct
    implementations drift apart there by a share of ``lr``, as two CPU runs
    whose weights differ in their last bits do. ``compiled`` (phase 42)
    picks another dense optimizer (``make_trainer``): adamw's moments are
    held as Adam's, adagrad's accumulator ``sum`` (no eps window: it starts
    at 0.1) as ``MOMENT_CHECKS`` says, its values rtol 1e-4 / atol 1e-6."""
    tag = f"[{spec.name} {table}{''.join(f' {k}={v}' for k, v in compiled.items())}]"
    host = [spec.batch(rng, spec.cpu_rows) for _ in range(CPU_STEPS)]
    card, cpu = (make_trainer(spec, table, device, leaves, host[0], seed, **compiled)
                 for device in ("cuda", "cpu"))
    for step, batch in enumerate(host, start=1):
        card_loss, cpu_loss = float(card.train_step(batch)), float(cpu.train_step(batch))
        close(torch.tensor([card_loss]), torch.tensor([cpu_loss]), rtol=1e-5, atol=0.0)
        bias = 1.0 - ADAM_BETA2 ** step
        optimizer = cpu.state.optimizer
        card_params = dict(card.model.named_parameters())
        card_moments = card.state.optimizer.state
        dense_err, exempt, notes = 0.0, 0, []
        moment_err = {}
        for name, param in cpu.model.named_parameters():
            if param not in optimizer.state:  # a table: the packed update trains it
                continue
            entry = optimizer.state[param]
            # adagrad has no eps window: a v_hat of ones puts no value in it
            v_hat = entry["exp_avg_sq"] / bias if "exp_avg_sq" in entry else torch.ones_like(param)
            err, n = adam_values_agree(f"{tag} step {step} {name}",
                                       card_params[name].detach().cpu(), param.detach(),
                                       v_hat, spec.lr)
            dense_err, exempt = max(dense_err, err), exempt + n
            for key, (form, atol) in MOMENT_CHECKS.items():
                if key not in entry:
                    continue
                try:
                    err = close(form(card_moments[card_params[name]][key].cpu()),
                                form(optimizer.state[param][key]), atol=atol)
                except AssertionError as fault:
                    raise AssertionError(f"{tag} step {step} {name} {key}: {fault}") from None
                moment_err[key] = max(moment_err.get(key, 0.0), err)
        for path, packed in cpu.state.packed.items():
            touched = torch.from_numpy(np.unique(spec.table_ids(path, batch)))
            got, want = card.state.packed[path][touched.cuda()].cpu(), packed[touched]
            if table == "int8":
                notes.append(int8_rows_agree(tag, path, got, want, spec.emb))
                continue
            emb = card._emb_dims[path]  # E = 1 for SVD++'s bias tables
            v_hat = want[:, 2 * emb:3 * emb].float() / bias
            if packed.dtype == torch.bfloat16:
                ulps, n = bf16_values_agree(f"{tag} step {step} {path}", got[:, :3 * emb],
                                            want[:, :3 * emb], v_hat, spec.lr)
                exempt += n
                notes.append(f"{path} bf16: {ulps} values one ulp apart ({touched.shape[0]} "
                             f"rows)")
                continue
            err, n = adam_values_agree(f"{tag} step {step} {path}", got[:, :emb], want[:, :emb],
                                       v_hat, spec.lr)
            moments = close(got[:, emb:3 * emb], want[:, emb:3 * emb])
            exempt += n
            notes.append(f"{path} values {err:.3e}, moments {moments:.3e} ({touched.shape[0]} "
                         f"rows)")
        for path, moments in cpu.state.table_moments.items():
            if not moments:  # a packed table's moments ride in its rows
                continue
            touched = torch.from_numpy(np.unique(spec.table_ids(path, batch)))
            name = path.replace("/", ".")
            got = card_params[name].detach()[touched.cuda()].cpu()
            err, n = adam_values_agree(f"{tag} step {step} {path}", got,
                                       dict(cpu.model.named_parameters())[name].detach()[touched],
                                       moments["v"][touched] / bias, spec.lr)
            moment_errs = [close(card.state.table_moments[path][k][touched.cuda()].cpu(),
                                 moments[k][touched]) for k in ("m", "v")]
            exempt += n
            notes.append(f"{path} values {err:.3e}, moments {max(moment_errs):.3e} "
                         f"({touched.shape[0]} rows)")
        moments = ", ".join(f"{key} {err:.3e}" for key, err in moment_err.items())
        print(f"{tag} card vs CPU, step {step} of {CPU_STEPS} at batch {spec.cpu_rows}: losses "
              f"{card_loss:.6f} / {cpu_loss:.6f}; max abs err: dense params {dense_err:.3e}, "
              f"their moments ({moments}); touched packed rows: {'; '.join(notes)}; "
              f"{exempt} values in Adam's eps window differ (each within 2.01 lr)")
        with torch.no_grad():  # the next step starts from the CPU's state on both
            for path, packed in cpu.state.packed.items():
                card.state.packed[path].copy_(packed)
            for path, moments in cpu.state.table_moments.items():
                for key, moment in moments.items():
                    card.state.table_moments[path][key].copy_(moment)
            for name, param in cpu.model.named_parameters():
                card_params[name].copy_(param)
        state = copy.deepcopy(cpu.state.optimizer.state_dict())  # never shared with the CPU's
        for saved, own in zip(state["param_groups"], card.state.optimizer.param_groups):
            saved.update({k: own[k] for k in ("fused", "foreach", "capturable")  # the card's
                          if k in own})
        card.state.optimizer.load_state_dict(state)
    del card, cpu


# phase 35: captured steps, N = 9 so that steps_per_call 4 runs 4 + 4 + a
# tail of 1; timed over CAPTURE_TIMED steps a run
CAPTURE_STEPS, CAPTURE_K, CAPTURE_TIMED = 9, 4, 20
CAPTURE_PATHS = (("dcnv2", "f32"), ("dcnv2", "int8"), ("dcnv2", "classic"), ("deepfm", "f32"),
                 ("din", "f32"), ("two_tower", "f32"))


def captured_values_agree(tag: str, spec: ModelSpec, table: str, eager, captured) -> list:
    """Every dense parameter, table and accumulator of the eager trainer
    against the captured one's: bit-equal, or named with its count of
    differing values and held to phase 21's tolerances (f32 rtol 1e-4 /
    atol 1e-6; int8 rows ``int8_rows_agree``). Returns the names that
    differ."""
    tables, their_tables = trained_tables(eager), trained_tables(captured)
    keys = {path.replace("/", ".") for path in tables}
    theirs = captured.model.state_dict()
    pairs = {f"param {k}": (v, theirs[k])
             for k, v in eager.model.state_dict().items() if k not in keys}
    pairs.update({f"table {k}": (v, their_tables[k]) for k, v in tables.items()})
    differ = []
    for name, (want, got) in pairs.items():
        if torch.equal(got, want):
            continue
        count = int((got != want).sum())
        if want.dtype == torch.uint8:
            note = int8_rows_agree(tag, name, got.cpu(), want.cpu(), spec.emb)
        elif want.dtype == torch.int8:
            note = f"q values: {count} differ, by up to {int((got.int() - want.int()).abs().max())}"
            if int((got.int() - want.int()).abs().max()) > 1 or count > max(1, want.numel() // 1000):
                raise AssertionError(f"{tag} {name}: {note}")
        else:
            note = f"max abs err {close(got.float(), want.float()):.3e}"
        differ.append(name)
        print(f"{tag} captured vs eager: {name} differs in {count} of {want.numel()} values "
              f"({note})")
    return differ


def time_eager(trainer, batches: list, steps: int):
    """CUDA events (and the host clock) around ``steps`` eager train steps
    on device-resident batches: (device ms a step, host ms a step)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for step in range(steps):
        trainer.train_step(batches[step % len(batches)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps, 1e3 * (time.perf_counter() - t0) / steps


def time_captured(trainer, packed: list, steps: int, k: int):
    """The same around one ``fit_steps(steps, steps_per_call=k)`` over
    batches packed on the device (its graphs captured already)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    trainer.fit_steps((packed[i % len(packed)] for i in range(steps)), steps=steps,
                      log_every=steps, steps_per_call=k)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps, 1e3 * (time.perf_counter() - t0) / steps


def capture_path(spec: ModelSpec, table: str, leaves: Optional[dict], rng: np.random.Generator,
                 seed: int, new_trainer: Optional[Callable] = None,
                 after: Optional[Callable] = None) -> dict:
    """Phase 35 for one model and table: two trainers from one state
    (``params_from_jax``), 2 N eager ``train_step``s against ``fit_steps(N,
    steps_per_call=1)`` then ``fit_steps(N, steps_per_call=4)`` over the
    same host batches (packed on the prefetch thread into pinned slots),
    launch counts from zero for each; every loss, dense parameter and table
    value compared (``captured_values_agree``); the launches of each graph's
    replay against the eager step's. Then eager and captured ms/step (CUDA
    events and the host clock over ``CAPTURE_TIMED`` steps, the captured
    ones over batches packed on the device) and a profiled replay of 4
    steps. ``new_trainer(sample)``, where given, makes each trainer in place
    of ``make_trainer`` from ``leaves``; ``after(captured trainer, host
    batches, tag)``, where given, runs last and its dict joins the result."""
    tag = f"[capture {spec.name} {table}]"
    per_step = spec.per_step[table]
    host = [spec.batch(rng, spec.train_rows) for _ in range(4)]
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()} for b in host]
    if new_trainer is None:
        new_trainer = functools.partial(make_trainer, spec, table, "cuda", leaves, seed=seed)
    eager, captured = new_trainer(host[0]), new_trainer(host[0])
    n = CAPTURE_STEPS

    zero_counts()
    eager_losses = torch.stack([eager.train_step(batches[i % 4]) for i in range(2 * n)])
    check_launches(f"{tag} {2 * n} eager steps", {k: 0 for k in ALL_KERNELS},
                   {k: v * 2 * n for k, v in per_step.items()})
    zero_counts()
    t0 = time.perf_counter()
    captured.fit_steps((host[i % 4] for i in range(n)), steps=n, log_every=n, steps_per_call=1)
    first = captured.step_losses.clone()
    history = captured.fit_steps((host[i % 4] for i in range(n, 2 * n)), steps=n, log_every=n,
                                 steps_per_call=CAPTURE_K)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    check_launches(f"{tag} fit_steps {n} + {n} (a warm-up step, then replays)",
                   {k: 0 for k in ALL_KERNELS}, {k: v * 2 * n for k, v in per_step.items()})
    captured_launches = names(counts())
    for k, graph in sorted(captured._graphs.items()):
        want = {kernel: v * k for kernel, v in per_step.items()}
        if graph.tally != want:
            raise AssertionError(f"{tag} the {k}-step graph launches {names(graph.tally)} a "
                                 f"replay, want {names(want)}")
    losses = torch.cat([first, captured.step_losses])
    if captured.state.step != eager.state.step or history.history["loss"] != [float(losses[-1])]:
        raise AssertionError(f"{tag} step {captured.state.step}, history {history.history}")
    differ = []
    if not torch.equal(losses, eager_losses):
        print(f"{tag} captured vs eager losses: {int((losses != eager_losses).sum())} of "
              f"{2 * n} differ, max abs err {close(losses.cpu(), eager_losses.cpu(), 1e-5, 0.0):.3e}")
        differ.append("loss")
    differ += captured_values_agree(tag, spec, table, eager, captured)
    print(f"{tag} {2 * n} steps eager and captured (graphs of {sorted(captured._graphs)} steps; "
          f"warm-up, captures and {2 * n} steps {capture_s:.1f} s): "
          + ("every loss, dense parameter and table value bit-equal" if not differ else
             f"differ in {differ}, each within phase 21's tolerance"))

    packer = captured.batch_packer(host[0])
    packed = [tuple(t.cuda() for t in packer.pack(b)) for b in host]
    eager_ms, eager_host = time_eager(eager, batches, CAPTURE_TIMED)
    one_ms, one_host = time_captured(captured, packed, CAPTURE_TIMED, 1)
    four_ms, four_host = time_captured(captured, packed, CAPTURE_TIMED, CAPTURE_K)
    one_again, _ = time_captured(captured, packed, CAPTURE_TIMED, 1)
    eager_again, _ = time_eager(eager, batches, CAPTURE_TIMED)
    wall, busy = profile_call(
        lambda: captured.fit_steps(iter(packed), steps=CAPTURE_K, log_every=CAPTURE_K,
                                   steps_per_call=CAPTURE_K),
        f"{tag} one replay of {CAPTURE_K} steps", {k: v * CAPTURE_K for k, v in per_step.items()},
        top=8)
    eager_wall, eager_busy = profile_call(lambda: eager.train_step(batches[0]),
                                          f"{tag} one eager step", per_step, top=4)
    out = {"eager_ms": [eager_ms, eager_again], "eager_host_ms": eager_host,
           "captured_ms": [one_ms, one_again], "captured_host_ms": one_host,
           f"captured_k{CAPTURE_K}_ms": four_ms, f"captured_k{CAPTURE_K}_host_ms": four_host,
           "replay_device_ms_per_step": None if busy is None else busy / CAPTURE_K,
           "replay_busy": None if busy is None else busy / wall,
           "eager_device_ms": eager_busy,
           "eager_busy": None if eager_busy is None else eager_busy / eager_wall,
           "launches_per_step": names(per_step), "captured_launches": captured_launches,
           "bit_equal": not differ, "differ": differ,
           "batch": spec.train_rows}
    print(f"{tag} ms/step (CUDA events over {CAPTURE_TIMED} steps, eager / captured 1 a replay "
          f"/ {CAPTURE_K} a replay / 1 a replay / eager): {eager_ms:.3f} / {one_ms:.3f} / "
          f"{four_ms:.3f} / {one_again:.3f} / {eager_again:.3f}; host clock {eager_host:.3f} / "
          f"{one_host:.3f} / {four_host:.3f}")
    if after is not None:
        out.update(after(captured, host, tag))
    del eager, captured, batches, packed
    gc.collect()
    torch.cuda.empty_cache()
    return out


def capture_phase(rng: np.random.Generator, seed: int) -> dict:
    """Phase 35: ``capture_path`` for each of ``CAPTURE_PATHS``."""
    specs = {"dcnv2": (DCNV2_SPEC, flax_leaves), "deepfm": (DEEPFM_SPEC, deepfm_leaves),
             "din": (DIN_SPEC, din_leaves), "two_tower": (TT_SPEC, tt_leaves)}
    capture = {}
    for offset, (name, table) in enumerate(CAPTURE_PATHS):
        spec, make_leaves = specs[name]
        leaves = make_leaves(np.random.default_rng(seed + 19 + offset), table)
        capture[f"{name}_{table}"] = capture_path(spec, table, leaves, rng, seed)
        del leaves
    return capture


# phase 36: captured requests against eager ones, and evaluation on the card
REQUEST_PATHS = ((DCNV2_SPEC, "f32"), (DCNV2_SPEC, "int8"), (DCNV2_SPEC, "classic"),
                 (DEEPFM_SPEC, "f32"), (DIN_SPEC, "f32"))
EVAL_BATCHES, EVAL_ROWS = 8, 1024  # DIN leave-one-out rows of DIN_LOO candidates
EVAL_METRICS = ("ndcg@10", "hit@10", "auc", "logloss")
STREAMING_AUC_BOUND = 1e-4  # the JAX docstring's bound for 16384 bins on spread scores


REPLAY_TIMED = 20  # replays timed by CUDA events for a request's device time


def memory_mb() -> dict:
    """The card's memory in MB once the caching allocator has returned every
    block no tensor or graph holds: what the live tensors and the graphs'
    pools keep."""
    gc.collect()
    torch.cuda.empty_cache()
    return {"allocated_mb": torch.cuda.memory_allocated() / 1e6,
            "reserved_mb": torch.cuda.memory_reserved() / 1e6}


def replay_device_ms(cache, key, iters: int = REPLAY_TIMED) -> float:
    """A request's device time: CUDA events around ``iters`` replays of its
    graph queued behind a device spin (``time_cuda``), without the request's
    copies. Each replay adds its graph's tally to the counts."""
    return time_cuda(lambda: cache.replay(key), iters=iters, warmup=1)


def host_times(fn, label: str, want: dict, repeats: int = REPEATS):
    """``repeats`` calls of ``fn`` on the host clock, each to a synchronize,
    each launching what ``want`` says: (median ms, the last result)."""
    times, out = [], None
    for _ in range(repeats):
        before = counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        check_launches(label, before, want)
    return float(np.median(times)), out


def results_equal(label: str, got, want) -> None:
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    for g, w in pairs:
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{label}: the captured request is not bit-equal to the eager "
                                 f"one ({int((g != w).sum())} values differ)")


def captured_requests(spec: ModelSpec, table: str, requests: list, seed: int) -> tuple:
    """Phase 36 for one model and table: each request through the eager
    model call (``serve.eager``) and through the captured scorer, on the
    host clock (median of ``REPEATS`` each, after a warm-up), bit-equal; a
    replay's device time (CUDA events) and a profiled replay, and the
    launches of a replay (its graph's tally); the memory the graphs hold.
    Returns (a row a request, kernel launches made)."""
    tag = f"[capture serving {spec.name} {table}]"
    kernel = spec.forward_kernel
    leaves = spec.leaves(np.random.default_rng(seed + 30), table)
    model = params_from_jax(leaves, spec.make(table, "cuda", seed))
    del leaves
    trainer = Trainer(model)
    serve = trainer.make_serving_fn()
    base = memory_mb()
    torch.cuda.reset_peak_memory_stats()
    rows, launched = {}, 0
    for name, req, shape in requests:
        one = {kernel: 1}
        serve.eager(req)  # cuBLAS handles and heuristics for the shape
        eager_ms, want = host_times(lambda: serve.eager(req), f"{tag} {name} eager", one)
        serve(req)  # the warm-up, then the capture and its first replay
        serve(req)
        captured_ms, got = host_times(lambda: serve(req), f"{tag} {name} captured", one)
        results_equal(f"{tag} {name}", got, want)
        signature = request_signature(req)
        tally = trainer._scores.tally(signature)
        if tally != one:
            raise AssertionError(f"{tag} {name}: a replay launches {names(tally)}")
        device = replay_device_ms(trainer._scores, signature)
        wall, profiled = profile_call(lambda: serve(req), f"{tag} {name} replay", one,
                                      host_top=6 if shape == (1,) else 0)
        launched += 2 * REPEATS + 4 + REPLAY_TIMED + 1
        rows[name] = {"eager_ms": eager_ms, "captured_ms": captured_ms, "device_ms": device,
                      "profiled_wall_ms": wall, "profiled_device_ms": profiled,
                      "replay_launches": names(tally), "examples": int(np.prod(shape))}
        print(f"{tag} {name:18s} eager {eager_ms:8.3f} ms, captured {captured_ms:8.3f} ms "
              f"(host clock, median of {REPEATS}); a replay's device time {device:.3f} ms (CUDA "
              f"events); bit-equal; a replay launches {names(tally)}")
    peak = torch.cuda.max_memory_allocated() / 1e6
    graphs = memory_mb()
    held = graphs["reserved_mb"] - base["reserved_mb"]
    print(f"{tag} the {trainer._scores.graphs()} graphs (one pool) and their static inputs hold "
          f"{held:.1f} MB of the card ({base['reserved_mb']:.1f} MB before the first request, "
          f"{graphs['reserved_mb']:.1f} after the last); peak allocated over the requests "
          f"{peak:.1f} MB")
    rows["memory"] = {"before": base, "after": graphs, "graphs_hold_mb": held,
                      "peak_allocated_mb": peak}
    del serve, trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return rows, launched


def captured_retrieval(seed: int) -> tuple:
    """Phase 36 for the two-tower model: fused requests of 1, 256 and 4096
    users at k=100 over the 1M-item bf16 index, eager against captured
    (host clock, median of ``REPEATS``), scores and ids bit-equal; a
    profiled replay each; the exact 4096-user request the same way, and
    recall@100 of the captured fused request against it. Returns (rows,
    B7 launches made)."""
    tag = "[capture retrieval two_tower f32]"
    rng = np.random.default_rng(seed + 31)
    model = params_from_jax(tt_leaves(rng, "f32"), make_two_tower("f32", "cuda", seed))
    index = build_item_index(model, TT_ITEMS, batch_size=TT_INDEX_BATCH)
    base = memory_mb()
    torch.cuda.reset_peak_memory_stats()
    fused, exact = make_retrieve_fn(model, approx="fused"), make_retrieve_fn(model)
    rows, launched = {}, 0
    paths = [(f"fused {n}", fused, n) for n in TT_REQUESTS] + [("exact 4096", exact, 4096)]
    results = {}
    for name, fn, n in paths:
        u_ids = rng.integers(0, TT_USERS, size=n).astype(np.int32) if name != "exact 4096" \
            else results["fused 4096"][0]
        one = {bin_max_scores: 1} if fn is fused else {}
        fn.eager(index, u_ids, TT_K)
        eager_ms, want = host_times(lambda: fn.eager(index, u_ids, TT_K), f"{tag} {name} eager",
                                    one)
        fn(index, u_ids, TT_K)
        fn(index, u_ids, TT_K)
        captured_ms, got = host_times(lambda: fn(index, u_ids, TT_K), f"{tag} {name} captured",
                                      one)
        results_equal(f"{tag} {name}", got, want)
        key = (id(index), (n,), TT_K)
        tally = fn.graphs.tally(key)
        if tally != one:
            raise AssertionError(f"{tag} {name}: a replay launches {names(tally)}")
        iters = REPLAY_TIMED if fn is fused else 3
        device = replay_device_ms(fn.graphs, key, iters)
        wall, profiled = profile_call(lambda: fn(index, u_ids, TT_K), f"{tag} {name} replay",
                                      one, top=8)
        launched += (2 * REPEATS + 4 + iters + 1) * (fn is fused)
        results[name] = (u_ids, got)
        rows[name] = {"eager_ms": eager_ms, "captured_ms": captured_ms, "device_ms": device,
                      "profiled_wall_ms": wall, "profiled_device_ms": profiled,
                      "replay_launches": names(tally)}
        print(f"{tag} {name:11s} eager {eager_ms:8.3f} ms, captured {captured_ms:8.3f} ms (host "
              f"clock, median of {REPEATS}); a replay's device time {device:.3f} ms (CUDA "
              f"events); scores and ids bit-equal")
    recall = recall_at_k(results["fused 4096"][1][1], results["exact 4096"][1][1])
    if recall < TT_RECALL_MIN:
        raise AssertionError(f"{tag} recall@{TT_K} {recall:.5f} below {TT_RECALL_MIN}")
    peak = torch.cuda.max_memory_allocated() / 1e6
    graphs = memory_mb()
    held = {"fused_and_exact": graphs["reserved_mb"] - base["reserved_mb"]}
    exact.graphs.clear()
    held["fused"] = memory_mb()["reserved_mb"] - base["reserved_mb"]
    rows.update(recall=recall, memory={"index_mb": index.nbytes / 1e6, "before": base,
                                       "after": graphs, "graphs_hold_mb": held,
                                       "peak_allocated_mb": peak})
    print(f"{tag} recall@{TT_K} of the captured fused 4096-user request against the captured "
          f"exact one: {recall:.5f}; the graphs (fused: 3, one pool; exact: 1) hold "
          f"{held['fused_and_exact']:.1f} MB of the card beside the {index.nbytes / 1e6:.1f} MB "
          f"index they keep alive ({held['fused']:.1f} MB the fused ones alone); peak "
          f"allocated over the requests {peak:.1f} MB")
    del fused, exact, index, model, results
    gc.collect()
    torch.cuda.empty_cache()
    return rows, launched


class ArrayReader:
    """The reader protocol ``evaluate`` and ``predict`` read: one split of
    columns of numpy arrays."""

    def __init__(self, split: dict):
        self.split = split

    def get_dataset_size(self, split: str) -> int:
        return len(self.split["uid"])

    def get_batch(self, split: str, indices) -> dict:
        return {k: v[indices] for k, v in self.split.items()}


def spread_din_leaves(rng: np.random.Generator) -> dict:
    """``din_leaves`` with the MLP's and the head's kernels N(0, 2 / fan_in):
    at N(0, 0.01) every score lies within 1e-3 of 0, so every sigmoid falls
    in one or two of the 16384 bins of the streaming AUC, which then says
    0.5 whatever the order; the JAX docstring's 1e-4 holds for scores that
    spread."""
    leaves = din_leaves(rng, "f32")
    for path, value in leaves.items():
        if path.startswith(("mlp/", "head/")) and path.endswith("kernel"):
            leaves[path] = he_leaf(rng, *value.shape)
    return leaves


def captured_evaluation(seed: int) -> tuple:
    """Phase 36's evaluation: ``predict`` and ``evaluate`` on the card over
    ``EVAL_BATCHES`` DIN batches of ``EVAL_ROWS`` leave-one-out rows of 100
    candidates at the full DIN width. ``predict`` bit-equal to the eager
    scorer on those batches; ``evaluate`` exactly ``MetricList`` of
    ``predict``'s output; ``streaming=True`` within ``STREAMING_AUC_BOUND``
    for AUC and rtol 1e-6 for NDCG, Hit and logloss. Returns (results, B5
    launches made)."""
    tag = "[capture evaluate din f32]"
    rng = np.random.default_rng(seed + 32)
    model = params_from_jax(spread_din_leaves(rng), make_din("f32", "cuda", seed))
    rows = EVAL_BATCHES * EVAL_ROWS
    split = make_din_batch(rng, rows)
    del split["label"]
    split["pos_his"][np.arange(DIN_STEPS)[None, :] >= split["pos_his_len"][:, None]] = 0
    split["iid"] = rng.integers(0, DIN_ITEMS, size=(rows, DIN_LOO)).astype(np.int32)
    reader = ArrayReader(split)
    trainer = Trainer(model)
    trainer.compile(metrics=EVAL_METRICS, user_sample_n=DIN_LOO)
    kernel = {din_attention_pool: EVAL_BATCHES}
    _, predictions = host_times(lambda: trainer.predict(reader, batch_size=EVAL_ROWS),
                                f"{tag} predict, the first (warm-up, capture)", kernel, 1)
    predict_ms, predictions = host_times(lambda: trainer.predict(reader, batch_size=EVAL_ROWS),
                                         f"{tag} predict", kernel, 3)
    serve = trainer.make_serving_fn()
    want = np.concatenate([serve.eager(reader.get_batch("test", np.arange(s, s + EVAL_ROWS)))
                           .cpu().numpy() for s in range(0, rows, EVAL_ROWS)])
    if predictions.shape != (rows, DIN_LOO) or not np.array_equal(predictions, want):
        raise AssertionError(f"{tag} predict is not bit-equal to the eager scorer")
    targets = np.zeros_like(predictions)
    targets[:, 0] = 1.0
    evaluate_ms, logs = host_times(lambda: trainer.evaluate(reader, batch_size=EVAL_ROWS,
                                                            verbose=0),
                                   f"{tag} evaluate", kernel, 1)
    exact = trainer.metrics(predictions, targets)
    if logs != exact:
        raise AssertionError(f"{tag} evaluate {logs} is not MetricList of predict's output "
                             f"{exact}")
    streaming_ms, streamed = host_times(
        lambda: trainer.evaluate(reader, batch_size=EVAL_ROWS, verbose=0, streaming=True),
        f"{tag} evaluate(streaming=True)", kernel, 1)
    for name, value in exact.items():
        err = abs(streamed[name] - value)
        bound = STREAMING_AUC_BOUND if name == "auc" else 1e-6 * abs(value)
        if not err <= bound:
            raise AssertionError(f"{tag} streaming {name} {streamed[name]} against {value}: "
                                 f"{err:.3e} over {bound:.1e}")
    spread = float(np.std(predictions))
    print(f"{tag} predict over {EVAL_BATCHES} x [{EVAL_ROWS}, {DIN_LOO}]: {predict_ms:.3f} ms "
          f"(host clock, median of 3), {rows / (predict_ms / 1e3):.0f} rows/s, "
          f"{rows * DIN_LOO / (predict_ms / 1e3):.0f} scored candidates/s; bit-equal to the "
          f"eager scorer; score std {spread:.3f}")
    print(f"{tag} evaluate {evaluate_ms:.3f} ms = MetricList of predict's output exactly: "
          f"{logs}; streaming {streaming_ms:.3f} ms: {streamed}")
    out = {"predict_ms": predict_ms, "predict_rows_per_s": rows / (predict_ms / 1e3),
           "predict_candidates_per_s": rows * DIN_LOO / (predict_ms / 1e3),
           "evaluate_ms": evaluate_ms, "streaming_ms": streaming_ms, "metrics": logs,
           "streaming": streamed, "rows": rows, "candidates": DIN_LOO}
    del trainer, model, serve
    gc.collect()
    torch.cuda.empty_cache()
    return out, (1 + 3 + 1 + 1) * EVAL_BATCHES + EVAL_BATCHES


def request_capture_phase(requests: list, din_requests: list, seed: int) -> dict:
    """Phase 36: captured requests against eager ones for every serving
    path, then evaluation on the card; launch counts from zero, read at
    the end."""
    zero_counts()
    want = {}
    out = {}
    for spec, table in REQUEST_PATHS:
        rows, n = captured_requests(spec, table, din_requests if spec is DIN_SPEC else requests,
                                    seed)
        out[f"{spec.name}_{table}"] = rows
        want[spec.forward_kernel] = want.get(spec.forward_kernel, 0) + n
    out["two_tower_f32"], n = captured_retrieval(seed)
    want[bin_max_scores] = n
    out["evaluate_din_f32"], n = captured_evaluation(seed)
    want[din_attention_pool] += n
    check_launches("phase 36", {k: 0 for k in ALL_KERNELS}, want)
    print(f"phase 36: launches {names(counts())}")
    return out


# phase 37: the fit loop on the captured step, its callbacks, state restored in place
FIT_TRAIN_BATCHES = 8  # train batches of TRAIN_BATCH rows an epoch
FIT_DEV_ROWS = TRAIN_BATCH + TRAIN_BATCH // 2  # 2 dev batches, the last short (padded)
FIT_METRICS = ("auc", "logloss")
FIT_TIMED_EPOCHS = 3  # epochs in each timed fit
FIT_STOP_EPOCHS = 8  # the most epochs of the early-stopping run
FIT_RESUME_TABLES = ("int8", "classic")


class FitReader:
    """The reader protocol ``fit`` reads, in memory: ``FIT_TRAIN_BATCHES``
    train batches and ``FIT_DEV_ROWS`` dev rows made as ``bench.py`` makes
    its batches, point-wise."""

    train_mode = TrainMode.POINT_WISE

    def __init__(self, rng: np.random.Generator):
        self.splits = {"train": make_train_batch(rng, FIT_TRAIN_BATCHES * TRAIN_BATCH),
                       "dev": make_train_batch(rng, FIT_DEV_ROWS)}

    def get_dataset_size(self, split: str) -> int:
        return len(self.splits[split]["label"])

    def get_train_dataset_size(self) -> int:
        return self.get_dataset_size("train")

    def get_batch(self, split: str, indices) -> dict:
        return {k: v[indices] for k, v in self.splits[split].items()}


class GraphSnapshot(Callback):
    """At each epoch's end: the trainer's step graphs by layout and the
    scorer's graph count (an epoch that captures nothing leaves both as
    they were)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def on_epoch_end(self, epoch, logs=None):
        self.seen.append(({key: {n: g.graph for n, g in layout.graphs.items()}
                           for key, layout in self.trainer._layouts.items()},
                          self.trainer._scores.graphs()))


def state_tensors(trainer) -> dict:
    """Every tensor training moves and a load writes (what a captured graph
    reads), by name: the model's parameters and buffers, the tables and
    accumulators (``trained_tables``) and the dense Adam's state."""
    out = {f"param {k}": v for k, v in trainer.model.state_dict().items()}
    out.update({f"table {k}": v for k, v in trained_tables(trainer).items()})
    names_of = {id(p): n for n, p in trainer.model.named_parameters()}
    for param, entry in trainer.state.optimizer.state.items():
        out.update({f"adam {names_of[id(param)]} {k}": v for k, v in entry.items()})
    return out


def fit_state(trainer) -> dict:
    return {k: v.detach().clone() for k, v in state_tensors(trainer).items()}


def pointers(trainer) -> dict:
    return {k: v.data_ptr() for k, v in state_tensors(trainer).items()}


def states_equal(label: str, got: dict, want: dict) -> None:
    """Raises unless both hold the same names and every value bit-equal."""
    differ = [k for k in want if k not in got or not torch.equal(got[k], want[k])]
    if differ or set(got) != set(want):
        raise AssertionError(f"{label}: differ in {differ[:8]} ({len(differ)} of {len(want)})"
                             f"; names {sorted(set(got) ^ set(want))[:4]}")


def time_fit(fn, steps: int):
    """CUDA events (and the host clock) around ``fn``, a whole fit or
    fit_steps call: (device-clock ms a step, host ms a step)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps, 1e3 * (time.perf_counter() - t0) / steps


def fit_against_fit_steps(table: str, reader: FitReader, seed: int, tmp: str):
    """``fit`` for 2 epochs (dev AUC and logloss after each) from a saved
    state, launch counts from zero, against ``fit_steps`` over the same
    shuffled batches from the same state: every loss and value bit-equal;
    the second epoch captures nothing; the dev metrics are the stepped
    trainer's ``evaluate``. Returns (the fitted trainer, its launches)."""
    tag = f"[fit dcnv2 {table}]"
    sample = reader.get_batch("train", np.arange(2))
    fitted = make_trainer(DCNV2_SPEC, table, "cuda",
                          flax_leaves(np.random.default_rng(seed + 40), table), sample, seed,
                          metrics=FIT_METRICS)
    start = os.path.join(tmp, f"start_{table}.pt")
    fitted.save_checkpoint(start)
    stepped = make_trainer(DCNV2_SPEC, table, "cuda",
                           flax_leaves(np.random.default_rng(seed + 41), table), sample,
                           seed + 1, metrics=FIT_METRICS)
    stepped.restore_checkpoint(start)  # the same state, from the file
    snapshot = GraphSnapshot()
    steps = 2 * FIT_TRAIN_BATCHES
    zero_counts()
    t0 = time.perf_counter()
    history = fitted.fit(reader, batch_size=TRAIN_BATCH, epochs=2, verbose=0, seed=seed,
                         callbacks=[snapshot])
    fit_s = time.perf_counter() - t0
    dev_batches = -(-FIT_DEV_ROWS // TRAIN_BATCH)
    want = {k: n * steps for k, n in DCNV2_SPEC.per_step[table].items()}
    want[cross_network] += 2 * dev_batches  # the dev scorer
    check_launches(f"{tag} fit: 2 epochs of {FIT_TRAIN_BATCHES} steps and 2 dev evaluations",
                   {k: 0 for k in ALL_KERNELS}, want)
    launches = names(counts())
    (first, scorer), (second, scorer_again) = snapshot.seen
    if second != first or scorer_again != scorer or not all(list(g) == [1]
                                                            for g in first.values()):
        raise AssertionError(f"{tag} the second epoch captured: graphs {first} then {second}, "
                             f"scorer {scorer} then {scorer_again}")
    logs = {k: v[-1] for k, v in history.history.items()}
    finite = np.isfinite(list(logs.values())).all()
    if list(history.history) != ["loss", *FIT_METRICS] or not finite:
        raise AssertionError(f"{tag} history {history.history}")
    rng = np.random.default_rng(seed)
    batches = [b for _ in range(2) for b in train_batches(reader, TRAIN_BATCH, rng)]
    stepped.fit_steps(iter(batches), steps=steps, log_every=FIT_TRAIN_BATCHES)
    if not torch.equal(fitted.step_losses, stepped.step_losses):
        raise AssertionError(f"{tag} fit's losses differ from fit_steps': "
                             f"{int((fitted.step_losses != stepped.step_losses).sum())} of {steps}")
    states_equal(f"{tag} fit against fit_steps", fit_state(fitted), fit_state(stepped))
    dev = stepped.evaluate(reader, split="dev", batch_size=TRAIN_BATCH, verbose=0)
    if dev != {k: logs[k] for k in FIT_METRICS}:
        raise AssertionError(f"{tag} dev metrics {logs} against the stepped trainer's {dev}")
    print(f"{tag} fit, 2 epochs of {FIT_TRAIN_BATCHES} x {TRAIN_BATCH} rows with dev AUC and "
          f"logloss ({dev_batches} dev batches, the last short) from a saved state: launches "
          f"{launches}; each layout's graphs {[list(g) for g in first.values()]}, the scorer's "
          f"{scorer}, none captured in epoch 2; {steps} losses and every value bit-equal to "
          f"fit_steps over the same batches; dev {dev} (the stepped trainer's evaluate); "
          f"{fit_s:.2f} s with warm-ups and captures")
    del stepped
    return fitted, launches


def fit_times(trainer, reader: FitReader, seed: int, tag: str) -> dict:
    """ms/step of ``fit`` without batch hooks, with ``TerminateOnNaN`` (a
    loss copied to the host each step) and of ``fit_steps`` over the same
    reader's batches: CUDA events around each whole call of
    ``FIT_TIMED_EPOCHS`` epochs, in turns, over unshuffled batches (each a
    contiguous slice of the reader's columns) and once each over shuffled
    ones; beside them the host's time to assemble one shuffled batch
    (``get_batch``: a gather of 32768 random rows from each column) and to
    pack it."""
    steps = FIT_TIMED_EPOCHS * FIT_TRAIN_BATCHES

    def fit(callbacks, shuffle):
        return lambda: trainer.fit(reader, batch_size=TRAIN_BATCH, epochs=FIT_TIMED_EPOCHS,
                                   verbose=0, seed=seed, eval_dev=False, callbacks=callbacks,
                                   shuffle=shuffle)

    def stepped(shuffle):
        def run():
            rng = np.random.default_rng(seed)
            batches = (b for _ in range(FIT_TIMED_EPOCHS)
                       for b in train_batches(reader, TRAIN_BATCH, rng, shuffle))
            trainer.fit_steps(batches, steps=steps, log_every=FIT_TRAIN_BATCHES)
        return run

    order = (("fit", fit(None, False)), ("fit_nan", fit([TerminateOnNaN()], False)),
             ("fit_steps", stepped(False)), ("fit_steps", stepped(False)),
             ("fit_nan", fit([TerminateOnNaN()], False)), ("fit", fit(None, False)),
             ("shuffled_fit", fit(None, True)), ("shuffled_fit_steps", stepped(True)))
    out = {}
    for name, fn in order:
        ms, host = time_fit(fn, steps)
        out.setdefault(f"{name}_ms", []).append(ms)
        out.setdefault(f"{name}_host_ms", []).append(host)
    indices = np.random.default_rng(seed).permutation(reader.get_train_dataset_size())
    packer = BatchPacker(reader.get_batch("train", indices[:TRAIN_BATCH]),
                         pin_memory=trainer.device.type == "cuda")
    gather, pack = [], []
    for i in range(5):
        t0 = time.perf_counter()
        batch = reader.get_batch("train", indices[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH])
        t1 = time.perf_counter()
        packer.pack(batch)
        gather.append(1e3 * (t1 - t0))
        pack.append(1e3 * (time.perf_counter() - t1))
    out["get_batch_ms"], out["pack_ms"] = float(np.median(gather)), float(np.median(pack))
    print(f"{tag} ms/step over {steps} steps (CUDA events around each call, in turns), "
          f"unshuffled: fit {out['fit_ms']}, fit with TerminateOnNaN {out['fit_nan_ms']}, "
          f"fit_steps over the reader's batches {out['fit_steps_ms']}; shuffled: fit "
          f"{out['shuffled_fit_ms']}, fit_steps {out['shuffled_fit_steps_ms']}; host clock "
          f"{out['fit_host_ms']}, {out['fit_nan_host_ms']}, {out['fit_steps_host_ms']}; a "
          f"shuffled batch's get_batch {out['get_batch_ms']:.3f} ms and pack "
          f"{out['pack_ms']:.3f} ms on the host (median of 5)")
    return out


class DevScores(Callback):
    """The dev split's predictions at each epoch's end (before the callbacks
    after it in the list act)."""

    def __init__(self, reader):
        super().__init__()
        self.reader, self.scores = reader, {}

    def on_epoch_end(self, epoch, logs=None):
        self.scores[epoch] = self.trainer.predict(self.reader, split="dev",
                                                  batch_size=TRAIN_BATCH)


def fit_early_stop(trainer, reader: FitReader, seed: int, tag: str) -> dict:
    """``EarlyStopping(patience=0, restore_best_weights=True)`` on the dev
    AUC with ``ModelCheckpoint(None)``: the run stops at the first epoch that
    does not improve, and the restored weights score the dev split bit-equal
    to the scores taken at the best epoch."""
    scores = DevScores(reader)
    t0 = time.perf_counter()
    history = trainer.fit(reader, batch_size=TRAIN_BATCH, epochs=FIT_STOP_EPOCHS, verbose=0,
                          seed=seed, callbacks=[
                              scores, EarlyStopping(monitor="auc", mode="max", patience=0,
                                                    restore_best_weights=True),
                              ModelCheckpoint(None, monitor="auc", mode="max")])
    run_s = time.perf_counter() - t0
    auc = history.history["auc"]
    stop = len(auc) - 1
    if not trainer.stop_training or stop < 1 or auc[stop] > auc[stop - 1] or any(
            auc[i] <= auc[i - 1] for i in range(1, stop)):
        raise AssertionError(f"{tag} early stopping: stop {trainer.stop_training}, AUC {auc}")
    best = stop - 1
    restored = trainer.predict(reader, split="dev", batch_size=TRAIN_BATCH)
    if trainer.best_params is None or not np.array_equal(restored, scores.scores[best]):
        raise AssertionError(f"{tag} the restored weights do not score as at epoch {best}")
    print(f"{tag} EarlyStopping(patience=0, restore_best_weights=True) + ModelCheckpoint(None) "
          f"on the dev AUC {auc}: stopped after epoch {stop}, the best {best}; the restored "
          f"weights score the dev split bit-equal to epoch {best}'s scores ({run_s:.2f} s)")
    return {"auc": auc, "stopped_epoch": stop, "best_epoch": best, "seconds": run_s}


def fit_resume(table: str, reader: FitReader, seed: int, tmp: str) -> dict:
    """Run A: 2 epochs of ``fit``, then 1. Run B: 2 epochs, ``save_checkpoint``;
    a trainer made from another seed (other weights, generator and key),
    which has trained an epoch (its steps captured), restores it in place
    and trains 1 epoch: every loss and value bit-equal to A's; launch counts
    from zero over that epoch."""
    tag = f"[fit resume dcnv2 {table}]"
    leaves = flax_leaves(np.random.default_rng(seed + 42), table)
    sample = reader.get_batch("train", np.arange(2))
    fit = dict(batch_size=TRAIN_BATCH, verbose=0, eval_dev=False)
    a = make_trainer(DCNV2_SPEC, table, "cuda", leaves, sample, seed)
    a.fit(reader, epochs=2, seed=seed + 1, **fit)
    a.fit(reader, epochs=1, seed=seed + 2, **fit)
    want_losses, want = a.step_losses.clone(), fit_state(a)
    want_key = getattr(a.state, "rng_key", None)
    del a
    b = make_trainer(DCNV2_SPEC, table, "cuda", leaves, sample, seed)
    b.fit(reader, epochs=2, seed=seed + 1, **fit)
    path = os.path.join(tmp, f"resume_{table}.pt")
    t0 = time.perf_counter()
    b.save_checkpoint(path)
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    del b
    c = make_trainer(DCNV2_SPEC, table, "cuda",
                     flax_leaves(np.random.default_rng(seed + 43), table), sample, seed + 7)
    c.fit(reader, epochs=1, seed=seed + 3, **fit)
    where = pointers(c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c.restore_checkpoint(path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if pointers(c) != where:
        raise AssertionError(f"{tag} restore_checkpoint moved a tensor")
    zero_counts()
    c.fit(reader, epochs=1, seed=seed + 2, **fit)
    check_launches(f"{tag} the resumed epoch", {k: 0 for k in ALL_KERNELS},
                   {k: n * FIT_TRAIN_BATCHES for k, n in DCNV2_SPEC.per_step[table].items()})
    launches = names(counts())
    if not torch.equal(c.step_losses, want_losses):
        raise AssertionError(f"{tag} the resumed epoch's losses differ from the "
                             f"uninterrupted run's")
    states_equal(tag, fit_state(c), want)
    if want_key is not None and not np.array_equal(c.state.rng_key, want_key):
        raise AssertionError(f"{tag} the rounding key was not restored")
    print(f"{tag} 2 + 1 epochs against 2, save_checkpoint, restore into a trainer from another "
          f"seed (captured already, no tensor moved), 1: {FIT_TRAIN_BATCHES} losses and every "
          f"table, accumulator, dense parameter and Adam moment bit-equal; checkpoint "
          f"{size / 1e6:.1f} MB, save {save_s:.3f} s, restore {restore_s:.3f} s; launches "
          f"{launches}")
    del c
    return {"bytes": size, "save_s": save_s, "restore_s": restore_s, "launches": launches}


def fit_loads_after_capture(trainer, reader: FitReader, seed: int, tmp: str, tag: str) -> None:
    """After captured steps and requests: ``load_weights`` of an earlier file,
    then a captured request equals ``serve.eager`` and the scores taken when
    the file was written, bit for bit; and one more captured step equals an
    eager ``train_step`` of a trainer restored to the same state."""
    serve = trainer.make_serving_fn()
    request = {k: v[:4096] for k, v in reader.splits["dev"].items() if k != "label"}
    serve(request)  # eager, then captured
    written = serve(request)
    path = os.path.join(tmp, "weights.pt")
    trainer.save_weights(path)
    trainer.fit(reader, batch_size=TRAIN_BATCH, epochs=1, verbose=0, seed=seed, eval_dev=False)
    if torch.equal(serve(request), written):
        raise AssertionError(f"{tag} the weights did not move")
    where = pointers(trainer)
    trainer.load_weights(path)
    if pointers(trainer) != where:
        raise AssertionError(f"{tag} load_weights moved a tensor")
    if not torch.equal(serve(request), written) or not torch.equal(serve.eager(request), written):
        raise AssertionError(f"{tag} after load_weights the captured request does not score "
                             f"as when the file was written")
    state_path = os.path.join(tmp, "loaded.pt")
    trainer.save_checkpoint(state_path)
    eager = make_trainer(DCNV2_SPEC, "f32", "cuda",
                         flax_leaves(np.random.default_rng(seed + 44), "f32"),
                         reader.get_batch("train", np.arange(2)), seed + 9)
    eager.restore_checkpoint(state_path)
    batch = reader.get_batch("train", np.arange(TRAIN_BATCH))
    before = counts()
    trainer.fit_steps(iter([batch]), steps=1, log_every=1)  # a replay
    check_launches(f"{tag} one captured step after the load", before,
                   DCNV2_SPEC.per_step["f32"])
    loss = eager.train_step(batch)
    if not torch.equal(trainer.step_losses[0], loss):
        raise AssertionError(f"{tag} the captured step after the load differs from the eager one")
    states_equal(f"{tag} captured step after load_weights against eager", fit_state(trainer),
                 fit_state(eager))
    print(f"{tag} load_weights after captured steps and requests: no tensor moved; the captured "
          f"[4096] request bit-equal to serve.eager and to the scores when the file was written; "
          f"one more captured step bit-equal to an eager train_step from the same state")
    del eager


def fit_phase(capture: dict, seed: int) -> dict:
    """Phase 37: the fit loop on the captured step at DCN-v2's full width
    (``bench.py``'s, no cut), f32 and int8 packed; resume for int8 packed
    and classic; loads after capture. Checkpoints go to a temporary
    directory (the process's ``TMPDIR``), removed at the end."""
    reader = FitReader(np.random.default_rng(seed + 39))
    out = {"train_rows": reader.get_train_dataset_size(), "dev_rows": FIT_DEV_ROWS,
           "batch": TRAIN_BATCH}
    with tempfile.TemporaryDirectory() as tmp:
        for table in ("f32", "int8"):
            tag = f"[fit dcnv2 {table}]"
            trainer, launches = fit_against_fit_steps(table, reader, seed, tmp)
            times = fit_times(trainer, reader, seed + 5, tag)
            captured_ms = capture[f"dcnv2_{table}"]["captured_ms"]
            print(f"{tag} phase 35's captured fit_steps (batches packed on the device) "
                  f"{captured_ms} ms/step in this run")
            out[table] = {"launches": launches, **times, "phase35_captured_ms": captured_ms}
            if table == "f32":
                out[table]["early_stop"] = fit_early_stop(trainer, reader, seed + 6, tag)
                fit_loads_after_capture(trainer, reader, seed + 8, tmp, tag)
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
        for table in FIT_RESUME_TABLES:
            out[f"resume_{table}"] = fit_resume(table, reader, seed, tmp)
            gc.collect()
            torch.cuda.empty_cache()
    return out


# phase 38: the factorization and sequence zoo on the captured trainers
ZOO_USERS, ZOO_ITEMS, ZOO_EMB = DIN_USERS, DIN_ITEMS, DIN_EMB  # scripts/din_sparse_ab.py:22-23
ZOO_BATCH, ZOO_CAND = DIN_BATCH, DIN_CAND  # [B, 2], positive first
ZOO_HIS, ZOO_SASREC_LAYERS = 50, 2  # RESULTS.md:724's SASRec serving configuration
ZOO_HIDDEN, ZOO_NCF_LAYERS, ZOO_DROPOUT = 64, (64,), 0.2
ZOO_REQUESTS = ((1, 500), (128, 500))  # candidate requests [B, N], history 50
ZOO_EVAL_BATCHES = 4  # SASRec's evaluate over this many [128, 500] batches
ZOO_METRICS = ("ndcg@10", "hit@10")
ZOO_CPU_ITEMS = 65_536  # the item tables' rows in the card-against-CPU check only
ZOO_CPU_BATCH = 512
ZOO_ROW_SCALE = 10.0  # table rows N(0, 0.1), as DIN's (din_leaves says why)
ZOO_LOSS = {"funk_svd": "bpr", "svdpp": "bpr", "ncf": "bpr", "gru4rec": "bce", "sasrec": "bce"}
ZOO_FIELDS = {"funk_svd": ("uid", "iid"), "svdpp": ("uid", "iid", "imp"), "ncf": ("uid", "iid"),
              "gru4rec": ("iid", "his", "his_len"), "sasrec": ("iid", "his", "his_len")}
# each model's packed tables under the f32 trainer and under the int8 one
ZOO_PACKED = {"funk_svd": (2, 1), "svdpp": (5, 2), "ncf": (4, 2), "gru4rec": (1, 1),
              "sasrec": (1, 1)}
ZOO_PATHS = (("funk_svd", "f32"), ("svdpp", "f32"), ("ncf", "f32"), ("gru4rec", "f32"),
             ("sasrec", "f32"), ("gru4rec", "int8"), ("sasrec", "int8"), ("svdpp", "int8"))


def make_zoo(name: str, table: str, device, seed: int, items: int = ZOO_ITEMS,
             dropout: float = ZOO_DROPOUT):
    """One model of the zoo at DIN's scale (65,536 users, ``items`` items,
    E=64), with f32 or int8 packed item tables: GRU4Rec (hidden 64) and
    SASRec (history 50, 2 shared layers) over histories of 50; NCF
    ``layers=(64,)``; NCF's and SASRec's dropout ``dropout``."""
    col = CategoricalColumnWithIdentity
    common = dict(emb_size=ZOO_EMB, quantized_table=table == "int8", device=device,
                  generator=torch.Generator(device=device).manual_seed(seed))
    if name in ("gru4rec", "sasrec"):
        cols = dict(iid_column=col("iid", items), his_column=col("his", items),
                    his_len_column=col("his_len", ZOO_HIS + 1), label_column=LABEL)
        if name == "gru4rec":
            return GRU4Rec(**cols, hidden_size=ZOO_HIDDEN, **common)
        return SASRec(**cols, max_his_len=ZOO_HIS, num_layers=ZOO_SASREC_LAYERS, dropout=dropout,
                      **common)
    cols = dict(uid_column=col("uid", ZOO_USERS), iid_column=col("iid", items), label_column=LABEL)
    if name == "funk_svd":
        return FunkSVD(**cols, **common)
    if name == "svdpp":
        return SVDPP(**cols, iids_column=col("imp", items), **common)
    return NCF(**cols, layers=ZOO_NCF_LAYERS, dropout=dropout, **common)


def skewed_ids(rng: np.random.Generator, shape, items: int) -> np.ndarray:
    """Item ids in [1, items) under a power law (``items * u**4``), so they
    repeat within a batch; 0 stays the PAD id."""
    return (1 + (items - 1) * rng.random(shape) ** 4).astype(np.int32)


def zoo_history(rng: np.random.Generator, rows: int, items: int):
    lengths = rng.integers(1, ZOO_HIS + 1, size=rows).astype(np.int32)
    his = skewed_ids(rng, (rows, ZOO_HIS), items)
    his[np.arange(ZOO_HIS)[None, :] >= lengths[:, None]] = 0  # PAD after the history
    return his, lengths


def make_zoo_batch(name: str, rng: np.random.Generator, rows: int, items: int = ZOO_ITEMS,
                   candidates: int = ZOO_CAND, label: bool = True) -> dict:
    """The fields ``name`` reads (``ZOO_FIELDS``): users uniform, skewed
    candidates ``[rows, candidates]`` whose negatives differ from the
    positive (first), histories of 1-50 ids then PAD (SVD++'s implicit one
    too), and with ``label`` the one-hot-first label."""
    iid = skewed_ids(rng, (rows, candidates), items)
    same = iid[:, 1:] == iid[:, :1]
    iid[:, 1:][same] = np.broadcast_to(iid[:, :1] % (items - 1) + 1, iid[:, 1:].shape)[same]
    batch = {"uid": rng.integers(0, ZOO_USERS, size=rows).astype(np.int32), "iid": iid}
    batch["his"], batch["his_len"] = zoo_history(rng, rows, items)
    batch["imp"], _ = zoo_history(rng, rows, items)
    batch = {k: batch[k] for k in ZOO_FIELDS[name]}
    if label:
        batch["label"] = np.zeros((rows, candidates), np.int32)
        batch["label"][:, 0] = 1
    return batch


def zoo_table_ids(path: str, batch: dict) -> np.ndarray:
    """The ids a zoo batch gathers from the packed table at ``path``: users,
    SVD++'s implicit history, or the candidates (then the history, for the
    sequence models: their item table serves both in one gather)."""
    if path.startswith(("u_", "mf_u", "mlp_u")):
        ids = batch["uid"]
    elif path.startswith("implicit"):
        ids = batch["imp"].reshape(-1)
    else:
        ids = batch["iid"].reshape(-1)
        if "his" in batch:
            ids = np.concatenate([ids, batch["his"].reshape(-1)])
    return ids.astype(np.int64)


def scale_zoo_rows(trainer) -> None:
    """Every table's rows times ``ZOO_ROW_SCALE``, in place: f32 tables
    (``Embedding``s, which the sparse trainer's are views of its packed
    buffers), and the int8 packed rows' f32 scale field."""
    with torch.no_grad():
        for module in trainer.model.modules():
            if isinstance(module, Embedding):
                module.embedding.mul_(ZOO_ROW_SCALE)
        for packed in trainer.state.packed.values():
            if packed.dtype == torch.uint8:
                packed.view(torch.float32)[:, ZOO_EMB // 4].mul_(ZOO_ROW_SCALE)


def zoo_trainer(name: str, table: str, device: str, seed: int, sample: dict,
                items: int = ZOO_ITEMS, dropout: float = ZOO_DROPOUT):
    """The zoo's training set-up: f32 packed tables under lazy Adam
    (``SparseEmbeddingTrainer``) or int8 packed item tables under rowwise
    Adagrad (``QuantizedEmbeddingTrainer``, the rest in the dense Adam),
    dense Adam at lr 1e-3, BPR for the factorization models and BCE for the
    sequence models; weights drawn by ``init_state(seed)``, table rows
    scaled to N(0, 0.1)."""
    model = make_zoo(name, table, device, seed, items, dropout)
    cls = SparseEmbeddingTrainer if table == "f32" else QuantizedEmbeddingTrainer
    trainer = cls(model, device=device, packed_tables=True)
    trainer.compile(optimizer="adam", lr=TRAIN_LR, loss=ZOO_LOSS[name], metrics=ZOO_METRICS,
                    user_sample_n=ZOO_REQUESTS[-1][1])
    trainer.init_state(sample, seed=seed)
    scale_zoo_rows(trainer)
    return trainer


def zoo_spec(name: str) -> ModelSpec:
    f32_tables, q_tables = ZOO_PACKED[name]
    return ModelSpec(
        name=name, make=functools.partial(make_zoo, name), leaves=None,
        batch=functools.partial(make_zoo_batch, name), table_ids=zoo_table_ids,
        tables={"f32": None, "int8": None}, q_name="i", forward_kernel=None, plain_forward=None,
        per_step={"f32": {segmented_sum_scan: f32_tables, scatter_set_rows: f32_tables},
                  "int8": {segmented_sum_scan: q_tables, requantize_rows: q_tables,
                           scatter_set_rows: q_tables}},
        train_rows=ZOO_BATCH, cpu_rows=ZOO_CPU_BATCH, cpu_request=None, emb=ZOO_EMB,
        scored_key="iid", loss=ZOO_LOSS[name])


def zoo_requests(name: str, rng: np.random.Generator) -> list:
    """The candidate requests (no label) of ``ZOO_REQUESTS``."""
    return [(f"[{b}, {n}]", make_zoo_batch(name, rng, b, candidates=n, label=False), (b, n))
            for b, n in ZOO_REQUESTS]


def zoo_serve(trainer, name: str, rng: np.random.Generator, tag: str) -> dict:
    """``make_serving_fn`` on the trained state: each request through the
    eager model call and through the captured scorer, bit-equal, on the
    host clock (median of ``REPEATS``), a replay's device time (CUDA
    events); no kernel launches (no zoo forward reaches one)."""
    serve = trainer.make_serving_fn()
    rows = {}
    for label, req, shape in zoo_requests(name, rng):
        serve.eager(req)
        eager_ms, want = host_times(lambda: serve.eager(req), f"{tag} {label} eager", {})
        serve(req)  # the warm-up, then the capture and its first replay
        serve(req)
        captured_ms, got = host_times(lambda: serve(req), f"{tag} {label} captured", {})
        results_equal(f"{tag} {label}", got, want)
        if tuple(got.shape) != shape or not torch.isfinite(got).all():
            raise AssertionError(f"{tag} {label}: scores {tuple(got.shape)}, want {shape}")
        device = replay_device_ms(trainer._scores, request_signature(req))
        rows[label] = {"eager_ms": eager_ms, "captured_ms": captured_ms, "device_ms": device}
        print(f"{tag} serve {label:10s} eager {eager_ms:8.3f} ms, captured {captured_ms:8.3f} ms "
              f"(host clock, median of {REPEATS}); a replay's device time {device:.3f} ms (CUDA "
              f"events); bit-equal")
    return rows


def zoo_evaluate(trainer, rng: np.random.Generator, tag: str) -> dict:
    """SASRec's ``evaluate`` (NDCG@10, Hit@10 over 500 candidates) over
    ``ZOO_EVAL_BATCHES`` batches of 128 rows of an in-memory reader: exactly
    ``MetricList`` of ``predict``'s output."""
    rows, n = ZOO_REQUESTS[-1]
    split = make_zoo_batch("sasrec", rng, rows * ZOO_EVAL_BATCHES, candidates=n, label=False)
    split["uid"] = np.arange(rows * ZOO_EVAL_BATCHES, dtype=np.int32)  # ArrayReader's size
    reader = ArrayReader(split)
    trainer.predict(reader, batch_size=rows)  # the warm-up, then the capture and its replays
    predict_ms, predictions = host_times(lambda: trainer.predict(reader, batch_size=rows),
                                         f"{tag} predict", {}, 3)
    evaluate_ms, logs = host_times(lambda: trainer.evaluate(reader, batch_size=rows, verbose=0),
                                   f"{tag} evaluate", {}, 3)
    exact = trainer.metrics(predictions)
    if predictions.shape != (rows * ZOO_EVAL_BATCHES, n) or logs != exact:
        raise AssertionError(f"{tag} evaluate {logs} is not MetricList of predict's output "
                             f"{exact}")
    print(f"{tag} evaluate over {ZOO_EVAL_BATCHES} x [{rows}, {n}]: {evaluate_ms:.3f} ms, "
          f"predict {predict_ms:.3f} ms (host clock, median of 3); {logs} = MetricList of "
          f"predict's output")
    return {"evaluate_ms": evaluate_ms, "predict_ms": predict_ms, "metrics": logs}


def zoo_path(name: str, table: str, rng: np.random.Generator, seed: int) -> dict:
    """Phase 38 for one model and table: phase 35's eager steps against
    captured ones at full width (``capture_path``, launches from zero), and
    for the f32 paths serving from the trained state and, SASRec, its
    evaluation; then phase 21's check at ``ZOO_CPU_ITEMS`` items, dropout 0
    (the card's and the CPU's generators draw different masks)."""
    spec = zoo_spec(name)
    new_trainer = functools.partial(zoo_trainer, name, table, "cuda", seed)

    def after(trainer, host, tag):
        for path, t in trained_tables(trainer).items():
            print(f"{tag} table {path} {tuple(t.shape)} {t.dtype}, {t.nbytes / 1e6:.1f} MB")
        if table != "f32":
            return {}
        out = {"requests": zoo_serve(trainer, name, rng, tag)}
        if name == "sasrec":
            out["evaluate"] = zoo_evaluate(trainer, rng, tag)
        return out

    out = capture_path(spec, table, None, rng, seed, new_trainer=new_trainer, after=after)
    gc.collect()
    torch.cuda.empty_cache()
    cut = dataclasses.replace(
        spec, make=functools.partial(make_zoo, name, items=ZOO_CPU_ITEMS, dropout=0.0),
        batch=functools.partial(make_zoo_batch, name, items=ZOO_CPU_ITEMS))
    sample = cut.batch(np.random.default_rng(seed), 2)
    leaves = leaves_of(zoo_trainer(name, table, "cpu", seed, sample, ZOO_CPU_ITEMS, 0.0))
    print(f"[zoo {name} {table}] card against CPU with the item tables cut to {ZOO_CPU_ITEMS} "
          f"rows (from {ZOO_ITEMS}) and dropout 0, at batch {ZOO_CPU_BATCH}")
    stepped_card_against_cpu(cut, table, leaves, rng, seed)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zoo_phase(rng: np.random.Generator, seed: int) -> dict:
    """Phase 38: ``zoo_path`` for each of ``ZOO_PATHS``; each path's
    launches from zero."""
    t0 = time.perf_counter()
    out = {}
    for name, table in ZOO_PATHS:
        out[f"{name}_{table}"] = zoo_path(name, table, rng, seed)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 38: {len(ZOO_PATHS)} paths in {out['seconds']:.1f} s")
    return out


# phase 39: the dataset path, from files made by the port's generators
# through the processing pipeline and a reader to Trainer.fit and evaluate
FILES_SEED = 2020
# MovieLens-1M's shape: 6,040 users, 3,706 items, about 1.0M ratings
FILES_ML = dict(n_users=6040, n_items=3706, min_interactions=20, max_interactions=311,
                seed=FILES_SEED)
# Adam's lr in both runs, as tests/test_torch_fit.py trains: the metric gates
# need the models to learn from init_state's weights within 2 epochs (DIN)
# and 1 (DCN-v2)
FILES_LR = 1e-2
# bench.py's Criteo shape: 13 dense fields, 26 sparse fields of 100,000 ids
FILES_CTR = dict(n_rows=1_048_576, n_dense=N_DENSE, seed=FILES_SEED,
                 sparse_vocab_sizes={f"c_{i}": VOCAB for i in range(N_SPARSE)})
FILES_RUNS = {
    "din": dict(generate=generate_synthetic_ml, data=FILES_ML, reader=HistoryDataReader,
                reader_kwargs=dict(split_mode=SplitMode.LEAVE_K_OUT, warm_n=5, leave_k=1,
                                   neg_sample_n=DIN_LOO - 1, train_mode=TrainMode.PAIR_WISE,
                                   max_his_len=DIN_STEPS, neg_sample_mode="fast"),
                loss="bpr", metrics=("ndcg@10", "hit@10"), batch=DIN_BATCH, epochs=2,
                score_batch=1024, spec=DIN_SPEC, gate=("hit@10", 1 / 10)),
    "dcnv2": dict(generate=generate_synthetic_ctr, data=FILES_CTR, reader=CTRDataReader,
                  reader_kwargs=dict(split_mode=SplitMode.SEQUENTIAL_SPLIT, warm_n=1,
                                     vt_ratio=0.1, train_mode=TrainMode.POINT_WISE),
                  loss="bce", metrics=("auc", "logloss"), batch=TRAIN_BATCH, epochs=1,
                  score_batch=TRAIN_BATCH, spec=DCNV2_SPEC, gate=("auc", 0.5)),
}


def files_model(name: str, columns: dict, seed: int):
    """The phase's model over a reader's feature columns: DIN at phase 35's
    width, or DCN-v2 at bench.py's, each with its f32 tables."""
    generator = torch.Generator(device="cuda").manual_seed(seed)
    if name == "din":
        col = CategoricalColumnWithIdentity
        items = columns["iid"].category_num
        return DIN(uid_column=columns["uid"], iid_column=columns["iid"],
                   his_column=col(feature_name="pos_his", category_num=items),
                   his_len_column=col(feature_name="pos_his_len", category_num=DIN_STEPS + 1),
                   label_column=columns["label"], emb_size=DIN_EMB, att_hidden_units=DIN_ATT,
                   mlp_layers=DIN_MLP, device="cuda", generator=generator)
    return DCNv2(sparse_columns=[columns[f"c_{i}"] for i in range(N_SPARSE)],
                 dense_columns=[columns[f"d_{i}"] for i in range(N_DENSE)],
                 label_column=columns["label"], emb_size=EMB, num_cross_layers=CROSS_LAYERS,
                 layers=MLP_UNITS, unified_embedding=True, device="cuda", generator=generator)


def files_trainer(name: str, reader, seed: int):
    run = FILES_RUNS[name]
    trainer = SparseEmbeddingTrainer(files_model(name, reader.get_feature_column_dict(), seed),
                                     device="cuda", packed_tables=True)
    trainer.compile(optimizer="adam", lr=FILES_LR, loss=run["loss"], metrics=run["metrics"],
                    user_sample_n=DIN_LOO)
    trainer.init_state(reader.get_batch("train", np.arange(2)), seed=seed)
    return trainer


def fit_batches(reader, batch_size: int, epochs: int, seed: int) -> list:
    """The batches ``fit`` deals over ``epochs``: each epoch's pair-wise
    negatives drawn first, the rows shuffled by one ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(epochs):
        if reader.train_mode == TrainMode.PAIR_WISE:
            reader.train_neg_sample()
        batches.extend(train_batches(reader, batch_size, rng))
    return batches


def files_run(name: str, seed: int, tmp: str) -> dict:
    """One run of phase 39: the dataset generated into the work dir, the
    reader built over it (its split, negative and history files made by the
    pipeline), ``fit`` with the dev metrics each epoch and ``evaluate`` on
    test, launch counts from zero across both; then ``fit_steps`` over the
    same batches from the same saved state, bit-equal; then one more epoch
    of ``fit`` (no dev), timed."""
    run = FILES_RUNS[name]
    tag = f"[files {name}]"
    t0 = time.perf_counter()
    run["generate"](f"Files-{name}", **run["data"])
    generate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    reader = run["reader"](f"Files-{name}", random_seed=FILES_SEED, **run["reader_kwargs"])
    reader_s = time.perf_counter() - t0
    sizes = {split: reader.get_dataset_size(split) for split in ("train", "dev", "test")}
    sizes["interactions"] = len(reader.interaction_frame["uid"])
    print(f"{tag} generated {run['data']} in {generate_s:.2f} s; {type(reader).__name__} "
          f"{run['reader_kwargs']} built in {reader_s:.2f} s (host clock): rows {sizes}")
    trainer = files_trainer(name, reader, seed)
    start = os.path.join(tmp, f"files_{name}.pt")
    trainer.save_checkpoint(start)
    epochs, batch, score_batch = run["epochs"], run["batch"], run["score_batch"]
    steps = epochs * (sizes["train"] // batch)
    zero_counts()
    fit_ms, fit_host_ms = time_fit(
        lambda: trainer.fit(reader, batch_size=batch, epochs=epochs, verbose=0, seed=seed,
                            dev_batch_size=score_batch), steps)
    history = trainer.history.history
    start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start_ev.record()
    test = trainer.evaluate(reader, split="test", batch_size=score_batch, verbose=0)
    end_ev.record()
    torch.cuda.synchronize()
    test_host_ms = 1e3 * (time.perf_counter() - t0)
    test_ms = start_ev.elapsed_time(end_ev)
    scored = epochs * -(-sizes["dev"] // score_batch) + -(-sizes["test"] // score_batch)
    want = {k: n * steps for k, n in run["spec"].per_step["f32"].items()}
    want[run["spec"].forward_kernel] += scored
    check_launches(f"{tag} fit ({steps} steps, {epochs} dev evaluations) and test evaluate",
                   {k: 0 for k in ALL_KERNELS}, want)
    launches = names(counts())
    losses = trainer.step_losses
    if len(losses) != steps or not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{tag} {len(losses)} losses for {steps} steps, finite "
                             f"{bool(torch.isfinite(losses).all())}")
    if list(history) != ["loss", *run["metrics"]] or not np.isfinite(
            [v for values in history.values() for v in values]).all():
        raise AssertionError(f"{tag} history {history}")
    metric, floor = run["gate"]
    gated = test[metric] if name == "din" else history[metric][-1]
    if not gated > floor:
        raise AssertionError(f"{tag} {metric} {gated} is not above {floor}")
    print(f"{tag} fit {epochs} epochs x {steps // epochs} steps of {batch} rows, dev "
          f"{[{k: history[k][e] for k in run['metrics']} for e in range(epochs)]}; test {test}; "
          f"launches {launches} ({scored} scoring batches of {score_batch} rows)")

    # fit_steps over the same batches from the same state: bit-equal
    stepped = files_trainer(name, reader, seed + 1)
    stepped.restore_checkpoint(start)
    if run["reader_kwargs"]["train_mode"] == TrainMode.PAIR_WISE:
        reader._fast_epoch = 0  # epoch e's negatives are seeded by (random_seed << 20) + e
    batches = fit_batches(reader, batch, epochs, seed)
    stepped.fit_steps(iter(batches), steps=steps, log_every=steps)
    del batches
    if not torch.equal(trainer.step_losses, stepped.step_losses):
        raise AssertionError(f"{tag} fit's losses differ from fit_steps': "
                             f"{int((trainer.step_losses != stepped.step_losses).sum())} of "
                             f"{steps}")
    states_equal(f"{tag} fit against fit_steps", fit_state(trainer), fit_state(stepped))
    del stepped
    gc.collect()
    torch.cuda.empty_cache()

    # steady ms/step: one more epoch, its layouts captured already
    epoch_steps = sizes["train"] // batch
    ms, host_ms = time_fit(lambda: trainer.fit(reader, batch_size=batch, epochs=1, verbose=0,
                                               seed=seed + 1, eval_dev=False), epoch_steps)
    out = {"generate_s": generate_s, "reader_s": reader_s, "rows": sizes, "steps": steps,
           "batch": batch, "fit_ms_per_step": fit_ms, "fit_host_ms_per_step": fit_host_ms,
           "epoch_ms_per_step": ms, "epoch_host_ms_per_step": host_ms,
           "test_ms": test_ms, "test_host_ms": test_host_ms, "score_batch": score_batch,
           "scoring_batches": scored, "dev": {k: history[k] for k in run["metrics"]},
           "test": test, "launches": launches}
    print(f"{tag} {steps} losses and every value bit-equal to fit_steps over the same batches; "
          f"fit {fit_ms:.3f} ms/step with dev scoring, warm-ups and captures (CUDA events; "
          f"host {fit_host_ms:.3f}), one more epoch {ms:.3f} ms/step (host {host_ms:.3f}); "
          f"test evaluate {test_ms:.3f} ms (host {test_host_ms:.3f})")
    del trainer, reader
    gc.collect()
    torch.cuda.empty_cache()
    return out


def files_phase(seed: int) -> dict:
    """Phase 39: ``files_run`` for DIN and DCN-v2, in a temporary work dir
    (``PYTORCHREC_TPU_WORK_DIR``, under the process's ``TMPDIR``) removed at
    the end."""
    t0 = time.perf_counter()
    previous = os.environ.get("PYTORCHREC_TPU_WORK_DIR")
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.environ["PYTORCHREC_TPU_WORK_DIR"] = tmp
            for name in FILES_RUNS:
                out[name] = files_run(name, seed, tmp)
    finally:
        if previous is None:
            os.environ.pop("PYTORCHREC_TPU_WORK_DIR", None)
        else:
            os.environ["PYTORCHREC_TPU_WORK_DIR"] = previous
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 39: {len(FILES_RUNS)} runs from files in {out['seconds']:.1f} s")
    return out


# phase 40: the streaming Criteo path, the example's twin at its defaults
CRITEO = dict(rows=500_000, steps=200, batch=8192, hash_bucket=VOCAB)
# "vocab" is the example's cap, which the synthetic data (1,000 raw ids a
# field) never reaches; "vocab_oov" caps below that, so about 30% of the
# traffic lands in the OOV buckets
CRITEO_RUNS = {"bf16": dict(matmul_precision="bfloat16", vocab_cap=0),
               "f32": dict(matmul_precision=None, vocab_cap=0),
               "vocab": dict(matmul_precision="bfloat16", vocab_cap=10_000),
               "vocab_oov": dict(matmul_precision="bfloat16", vocab_cap=700)}
CRITEO_AUC_MIN = 0.70  # held-out AUC of each run
CRITEO_AUC_GAP = 0.01  # the bf16 run's held-out AUC against the f32 run's
CRITEO_CAPTURE_STEPS = 8  # eager against captured bf16 steps: 4 at 1 a replay, 4 at 4
# a bf16 GEMM with an f32 output against the emulation (operands rounded to
# bf16, an f32 product): f32 sums in another order, far below bf16's 2**-9
BF16_GEMM_SHAPE = (8192, DIM, MLP_UNITS[0])
BF16_GEMM_RTOL = 1e-5


def bf16_gemm_check() -> dict:
    """The card's bf16 GEMM as the trainer runs it (``ops/precision.py::
    bf16_mm``): an f32 tensor within f32 rounding of the emulation's
    product (relative to the product's largest value), where a bf16 output
    would lie a bf16 rounding away."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    m, k, n = BF16_GEMM_SHAPE
    a = torch.randn(m, k, device="cuda", generator=gen)
    b = torch.randn(k, n, device="cuda", generator=gen)
    got = bf16_mm(a, b)
    emulated = torch.mm(a.bfloat16().float(), b.bfloat16().float())
    bf16_out = torch.mm(a.bfloat16(), b.bfloat16()).float()
    scale = float(emulated.abs().max())
    err = float((got - emulated).abs().max()) / scale
    bf16_err = float((bf16_out - emulated).abs().max()) / scale
    if got.dtype != torch.float32 or not err < BF16_GEMM_RTOL < bf16_err:
        raise AssertionError(f"bf16 GEMM: dtype {got.dtype}, {err:.3e} of the emulation's "
                             f"largest value (a bf16 output: {bf16_err:.3e})")
    print(f"[criteo] bf16 GEMM {BF16_GEMM_SHAPE} with an f32 output: within {err:.3e} of the "
          f"emulation (a bf16 output {bf16_err:.3e})")
    return {"shape": list(BF16_GEMM_SHAPE), "rel_err": err, "bf16_out_rel_err": bf16_err}


def layout_copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x``; a 2-D view with unit column stride keeps its row
    stride and its offset within a row (B2 reads its input at the packed
    table's row stride)."""
    if x.is_contiguous():
        return x.clone()
    assert x.dim() == 2 and x.stride(1) == 1, (x.shape, x.stride())
    stride, offset = x.stride(0), x.storage_offset() % x.stride(0)
    rows = torch.zeros((x.shape[0], stride), dtype=x.dtype, device=x.device)
    return rows[:, offset:offset + x.shape[1]].copy_(x)


@contextlib.contextmanager
def recording(owner, name: str, calls: dict):
    """Inside: ``owner.name`` runs the kernel as before and keeps copies of
    its first call's arguments in ``calls[name]``, made before the call
    (B4 writes into its table)."""
    kernel = getattr(owner, name)

    def record(*args):
        if name not in calls:
            calls[name] = [layout_copy(a.detach()) if isinstance(a, torch.Tensor) else a
                           for a in args]
        return kernel(*args)

    with swapped(owner, name, record):
        yield


def criteo_kernels_against_plain(calls: dict) -> dict:
    """B1, B2 and B4 against their plain versions on the arguments the first
    eager bf16 step of the example gave them (``recording``): the cross
    forward on the step's x0 at phase 3's tolerances; the scan on the
    sorted staged gradients, at the packed table's row stride, rtol 1e-5
    and atol 1e-5 of the largest |sum| (f32 sums in another order); the
    scatter of the update's rows into a copy of the table, bit-exact."""
    tag = "[criteo kernels]"
    out = {}
    with torch.no_grad():
        x0, ws, bs = calls["cross_network"]
        out["cross_network"] = close(cross_network(x0, ws, bs), cross_network_plain(x0, ws, bs))
        print(f"{tag} cross_network kernel vs plain  x0 {list(x0.shape)}, {ws.shape[0]} layers "
              f"({plan_name(x0.shape[0], x0.shape[1])}): max abs err {out['cross_network']:.3e}")
        x, heads = calls["segmented_sum_scan"]
        want = segmented_sum_scan_plain(x, heads)
        scale = float(want.abs().max())
        out["segmented_sum_scan"] = close(segmented_sum_scan(x, heads), want, rtol=1e-5,
                                          atol=1e-5 * scale)
        print(f"{tag} segmented_sum_scan kernel vs plain  {list(x.shape)} at row stride "
              f"{x.stride(0)}, {int(heads.sum())} segments: max abs err "
              f"{out['segmented_sum_scan']:.3e} (largest |sum| {scale:.3e})")
        table, rows, ids = calls["scatter_set_rows"]
        want = scatter_set_rows_plain(table.clone(), rows, ids)
        scatter_set_rows(table, rows, ids)
        torch.cuda.synchronize()
        if not torch.equal(table, want):
            raise AssertionError(f"{tag} scatter_set_rows kernel differs from its plain version")
        out["scatter_set_rows"] = 0.0
        kept = int((ids < table.shape[0]).sum())
        print(f"{tag} scatter_set_rows kernel vs plain  {rows.shape[0]} rows ({kept} kept) into "
              f"{list(table.shape)} {table.dtype}: bit-exact")
    return out


def criteo_captured_against_eager(data: dict, seed: int) -> dict:
    """Two bf16 trainers of the example from one state (``init_state(seed)``
    on the first streamed batch): ``CRITEO_CAPTURE_STEPS`` eager
    ``train_step``s against ``fit_steps`` (a warm-up step, then replays of
    a 1-step graph, then of a 4-step graph) over the same batches; every
    loss and state tensor bit-equal, launches of each from zero. The first
    eager step's kernel arguments go to ``criteo_kernels_against_plain``."""
    tag = "[criteo capture bf16]"
    batch, n = CRITEO["batch"], CRITEO_CAPTURE_STEPS
    sparse, _, _ = criteo_twin.vocab_transform(data["train"], batch, 0, VOCAB)
    host = list(islice(criteo_twin.train_source(data, batch).batches(), n))
    eager, captured = (criteo_twin.make_trainer(criteo_twin.make_model(sparse, "cuda"), "cuda",
                                                "bfloat16") for _ in range(2))
    for trainer in (eager, captured):
        trainer.init_state(host[0], seed=seed)
    states_equal(f"{tag} initial state", fit_state(captured), fit_state(eager))
    want = {cross_network: n, segmented_sum_scan: n, scatter_set_rows: n}
    zero_counts()
    calls = {}
    with recording(interactions_module, "cross_network", calls), \
            recording(sparse_update_module, "segmented_sum_scan", calls), \
            recording(sparse_update_module, "scatter_set_rows", calls):
        first = eager.train_step(host[0])
    eager_losses = torch.stack([first, *(eager.train_step(b) for b in host[1:])])
    check_launches(f"{tag} {n} eager steps", {k: 0 for k in ALL_KERNELS}, want)
    against_plain = criteo_kernels_against_plain(calls)
    del calls
    zero_counts()
    captured.fit_steps(iter(host[:n // 2]), steps=n // 2, log_every=n)
    first = captured.step_losses.clone()
    captured.fit_steps(iter(host[n // 2:]), steps=n - n // 2, log_every=n,
                       steps_per_call=CAPTURE_K)
    check_launches(f"{tag} fit_steps {n // 2} + {n - n // 2}", {k: 0 for k in ALL_KERNELS}, want)
    losses = torch.cat([first, captured.step_losses])
    if not torch.equal(losses, eager_losses):
        raise AssertionError(f"{tag} losses differ: {losses.tolist()} / {eager_losses.tolist()}")
    states_equal(f"{tag} captured against eager", fit_state(captured), fit_state(eager))
    print(f"{tag} {n} steps eager and captured (graphs of {sorted(captured._graphs)} steps): "
          f"every loss and state tensor bit-equal")
    del eager, captured
    gc.collect()
    torch.cuda.empty_cache()
    return {"steps": n, "bit_equal": True, "max_abs_err": against_plain}


def criteo_run(name: str, data: dict) -> dict:
    """One run of the example over the prepared shards (``criteo_twin.run``),
    launch counts from zero, and its checks."""
    tag = f"[criteo {name}]"
    zero_counts()
    out = criteo_twin.run(**CRITEO, **CRITEO_RUNS[name], device="cuda", data=data, verbose=0,
                          log=lambda message: print(f"{tag} {message}"))
    trainer, losses = out.pop("trainer"), out.pop("step_losses")
    steps, batch = CRITEO["steps"], CRITEO["batch"]
    scored = out["heldout_rows"] // batch
    check_launches(f"{tag} {steps} steps and {scored} held-out batches",
                   {k: 0 for k in ALL_KERNELS},
                   {cross_network: steps + scored, segmented_sum_scan: steps,
                    scatter_set_rows: steps})
    windows = out["window_losses"]
    if len(losses) != steps or not np.isfinite(losses).all() or not windows[-1] < windows[0]:
        raise AssertionError(f"{tag} {len(losses)} losses, finite {np.isfinite(losses).all()}, "
                             f"windows {windows}")
    if scored != criteo_twin.HELDOUT_BATCHES or not out["heldout_auc"] > CRITEO_AUC_MIN:
        raise AssertionError(f"{tag} held-out AUC {out['heldout_auc']} over {scored} batches")
    print(f"{tag} {steps} steps of {batch} rows over {out['table_rows']} table rows (coverage "
          f"{out['coverage']:.4f}): windows {[round(w, 5) for w in windows]}, p50 "
          f"{out['p50_ms']:.3f} ms/step, {out['examples_per_s']:.0f} examples/s (host clock), "
          f"held-out AUC {out['heldout_auc']:.4f}; launches {out['launches']}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def criteo_phase(seed: int, work_dir: str) -> dict:
    """Phase 40 in the work dir ``work_dir`` (``PYTORCHREC_TPU_WORK_DIR``, a
    temporary dir under the process's ``TMPDIR`` that phase 47 reads again
    and ``main`` removes)."""
    t0 = time.perf_counter()
    previous = os.environ.get("PYTORCHREC_TPU_WORK_DIR")
    out = {}
    try:
        os.environ["PYTORCHREC_TPU_WORK_DIR"] = work_dir
        data = criteo_twin.prepare(CRITEO["rows"], CRITEO["hash_bucket"],
                                   log=lambda message: print(f"[criteo] {message}"))
        out["data"] = {k: data[k] for k in ("synth_s", "format_s")}
        out["data"]["shards"] = len(data["shards"])
        print(f"[criteo] {CRITEO['rows']} raw rows synthesized in {data['synth_s']:.2f} s, "
              f"formatted into {len(data['shards'])} .npz shards in {data['format_s']:.2f} s "
              f"(host clock)")
        out["bf16_gemm"] = bf16_gemm_check()
        out["capture"] = criteo_captured_against_eager(data, seed)
        for name in CRITEO_RUNS:
            out[name] = criteo_run(name, data)
    finally:
        if previous is None:
            os.environ.pop("PYTORCHREC_TPU_WORK_DIR", None)
        else:
            os.environ["PYTORCHREC_TPU_WORK_DIR"] = previous
    if not out["vocab_oov"]["coverage"] < 1.0:
        raise AssertionError(f"[criteo vocab_oov] coverage {out['vocab_oov']['coverage']}: "
                             f"no traffic reached the OOV buckets")
    gap = abs(out["bf16"]["heldout_auc"] - out["f32"]["heldout_auc"])
    if not gap <= CRITEO_AUC_GAP:
        raise AssertionError(f"[criteo] bf16 held-out AUC {out['bf16']['heldout_auc']} is "
                             f"{gap:.4f} from f32's {out['f32']['heldout_auc']}")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 40: the streaming Criteo path, {len(CRITEO_RUNS)} runs in "
          f"{out['seconds']:.1f} s; bf16 AUC {gap:.4f} from f32's")
    return out


# phase 41: DLRM and the sparse trainer's other table formats
DLRM_BOTTOM, DLRM_TOP = (64,), MLP_UNITS  # the JAX model's defaults, (64,) and (256, 128)
DLRM_PAIRS = (N_SPARSE + 1) * N_SPARSE // 2  # 27 field vectors: 351 interactions
DLRM_TOP_IN = EMB + DLRM_PAIRS  # 367
DLRM_REQUESTS = (1, 256, 4096)
# DLRM's rows N(0, 0.1), as DIN's (din_leaves says why): at N(0, 0.01) a
# row's gradient, a sum over the other 26 vectors, lies in Adam's eps window
DLRM_ROW_SCALE = 10.0
FORMAT_STEPS = 25  # captured fit_steps of each phase-41 training path, launches from zero
FORMAT_ROUNDS = 2  # timed rounds over the contenders, interleaved
FORMAT_CPU_BATCH = 512  # the stepped card-against-CPU checks
# scripts/packed_bytes_ab.py:79-90's contenders, (table format, table
# optimizer), at its DCN-v2 configuration (bf16 matmuls, as its compile)
CONTENDERS = (("f32", "adam"), ("bytes", "adam"), ("bytes", "rowwise_adagrad"),
              ("f32", "rowwise_adagrad"), ("bf16", "adam"), ("bf16", "rowwise_adagrad"),
              ("bf16w128", "adam"))
CONTENDER_PRECISION = "bfloat16"


def contender_name(table: str, optimizer: str) -> str:
    return f"{table}/{'rowwise' if optimizer == 'rowwise_adagrad' else optimizer}"


def dlrm_leaves(rng: np.random.Generator, table: str) -> dict:
    """Random DLRM parameters in the flax leaf layout: the MLPs N(0, 0.01)
    with ``bottom_proj`` and ``top_head`` biases zero (flax's ``nn.Dense``
    default), the table rows N(0, 0.1): 26 per-field ``[100000, 16]``
    tables (``"per_field"``) or the unified table as ``table_leaves`` lays
    it out."""
    leaves = {}
    width = N_DENSE
    for i, units in enumerate(DLRM_BOTTOM):
        leaves[f"bottom/Dense_{i}/Dense_0/kernel"] = normal_leaf(rng, width, units)
        leaves[f"bottom/Dense_{i}/Dense_0/bias"] = normal_leaf(rng, units)
        width = units
    leaves["bottom_proj/kernel"] = normal_leaf(rng, width, EMB)
    leaves["bottom_proj/bias"] = np.zeros(EMB, np.float32)
    width = DLRM_TOP_IN
    for i, units in enumerate(DLRM_TOP):
        leaves[f"top/Dense_{i}/Dense_0/kernel"] = normal_leaf(rng, width, units)
        leaves[f"top/Dense_{i}/Dense_0/bias"] = normal_leaf(rng, units)
        width = units
    leaves["top_head/kernel"] = normal_leaf(rng, width, 1)
    leaves["top_head/bias"] = np.zeros(1, np.float32)
    if table == "per_field":
        for i in range(N_SPARSE):
            leaves[f"emb_c_{i}/embedding"] = normal_leaf(rng, VOCAB, EMB) * np.float32(
                DLRM_ROW_SCALE)
        return leaves
    rows = normal_leaf(rng, N_SPARSE * VOCAB, EMB) * np.float32(DLRM_ROW_SCALE)
    if table == "f32":
        leaves["unified_emb/embedding"] = packed_f32_leaf(rows, PACKED_W)
    elif table == "int8":
        leaves["unified_q"] = packed_q_leaf(rows, Q_W)
    else:
        leaves.update(classic_q_leaves(rows, *CLASSIC[table]))
    return leaves


def make_dlrm(table: str, device, seed: int) -> DLRM:
    """DLRM at phase 35's Criteo width: 26 fields of 100,000 ids, 13 dense
    columns, E=16, bottom (64,), top (256, 128); per-field tables for
    ``"per_field"``, else the unified table of ``table``."""
    sparse = [CategoricalColumnWithIdentity(feature_name=f"c_{i}", category_num=VOCAB)
              for i in range(N_SPARSE)]
    dense = [NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)]
    quantized = table not in SPARSE_FORMATS
    return DLRM(sparse_columns=sparse, dense_columns=dense, label_column=LABEL, emb_size=EMB,
                bottom_layers=DLRM_BOTTOM, top_layers=DLRM_TOP,
                unified_embedding=table != "per_field", quantized_embedding=quantized,
                table_packed=table == "int8", device=device,
                generator=torch.Generator(device=device).manual_seed(seed))


def dlrm_table_ids(path: str, batch: dict) -> np.ndarray:
    """The ids a DLRM batch gathers from the table at ``path``."""
    if path.startswith("emb_"):
        return batch[path.split("/")[0][len("emb_"):]].astype(np.int64)
    return unified_ids(batch)


DLRM_SPEC = dataclasses.replace(
    DCNV2_SPEC, name="dlrm", make=make_dlrm, leaves=dlrm_leaves, table_ids=dlrm_table_ids,
    forward_kernel=None,
    plain_forward=lambda model: contextlib.nullcontext(),
    per_step={"f32": {segmented_sum_scan: 1, scatter_set_rows: 1},
              "int8": {segmented_sum_scan: 1, requantize_rows: 1, scatter_set_rows: 1},
              "classic": {segmented_sum_scan: 1, stochastic_quantize_rows: 1,
                          scatter_set_rows: 2},
              # unpacked lazy Adam of 26 tables: each a dedup scan and the
              # scatter-sets of the table, m and v
              "per_field": {segmented_sum_scan: N_SPARSE, scatter_set_rows: 3 * N_SPARSE}},
    cpu_rows=FORMAT_CPU_BATCH)
FORMATS_SPEC = dataclasses.replace(
    DCNV2_SPEC, name="dcnv2 formats",
    per_step={t: DCNV2_SPEC.per_step["f32"] for t in SPARSE_FORMATS},
    cpu_rows=FORMAT_CPU_BATCH)


def format_leaves(leaves: dict, table: str, optimizer: str) -> dict:
    """``leaves`` (DCN-v2's, the packed f32 table under Adam) with the table in
    ``table``'s layout under ``optimizer``: the same rows, zero moments
    (the port's own packing)."""
    rows = torch.from_numpy(leaves[TABLES["f32"]][:, :EMB])
    args = SPARSE_FORMATS[table]
    min_width = args.get("packed_min_width", 64)
    if args.get("packed_bytes"):
        leaf = pack_table_bytes(rows, optimizer, min_width)
    else:
        dtype = torch.bfloat16 if args.get("packed_dtype") else None
        leaf = pack_table(rows, optimizer, min_width, dtype)
    return {**leaves, TABLES["f32"]: leaf}


def recorded_key(name: str, args) -> tuple:
    """A kernel call's key: its name and each tensor argument's shape, dtype
    and row stride (calls that differ only in values share it)."""
    return (name, *((tuple(a.shape), str(a.dtype), a.stride(0) if a.dim() > 1 else 1)
                    for a in args if isinstance(a, torch.Tensor)))


@contextlib.contextmanager
def recording_shapes(owners, name: str, calls: dict):
    """Inside: each ``owner.name`` runs the kernel as before and keeps copies
    of the arguments of its first call of each shape (``recorded_key``) in
    ``calls``, made before the call; keyword arguments too (B8's ids and
    salt)."""
    kernel = getattr(owners[0], name)

    def copy_of(a):
        return layout_copy(a.detach()) if isinstance(a, torch.Tensor) else a

    def record(*args, **kwargs):
        key = recorded_key(name, (*args, *kwargs.values()))
        if key not in calls:
            calls[key] = ([copy_of(a) for a in args], {k: copy_of(v) for k, v in kwargs.items()})
        return kernel(*args, **kwargs)

    with contextlib.ExitStack() as stack:
        for owner in owners:
            stack.enter_context(swapped(owner, name, record))
        yield


@contextlib.contextmanager
def recording_update_kernels(calls: dict):
    """``recording_shapes`` for B2, B3, B4 and B8 where the table updates call
    them: the sparse, int8 packed and classic updates."""
    modules = (sparse_update_module, quantized_packed_module, quantized_trainer_module)
    with contextlib.ExitStack() as stack:
        for name in ("segmented_sum_scan", "scatter_set_rows", "requantize_rows",
                     "stochastic_quantize_rows"):
            owners = [m for m in modules if hasattr(m, name)]
            stack.enter_context(recording_shapes(owners, name, calls))
        yield


def update_kernels_against_plain(calls: dict, tag: str = "[phase 41 kernels]") -> dict:
    """Each recorded call against its plain version on the same arguments:
    B2 rtol 1e-5 and atol 1e-5 of the largest |sum| (f32 sums in another
    order), B3, B4 and B8 bit-exact. B2 and B4, whose row widths here are
    new, are timed too (``time_cuda``, median of 3 rounds) beside their
    bytes' bound: B2 reads x and writes its sums, B4 reads the ids and each
    kept row and writes it; B4 also beside ``index_copy_`` of the kept rows.
    Returns each kernel's max abs error and the calls checked."""
    out = {}
    with torch.no_grad():
        for key, (args, kwargs) in calls.items():
            name, shapes = key[0], [list(k[0]) for k in key[1:]]
            timing = {}
            if name == "segmented_sum_scan":
                want = segmented_sum_scan_plain(*args)
                scale = max(float(want.abs().max()), 1e-30)
                err = close(segmented_sum_scan(*args), want, rtol=1e-5, atol=1e-5 * scale)
                note = f"row stride {args[0].stride(0)}, largest |sum| {scale:.3e}"
                timing = {"ms": float(np.median([time_cuda(lambda: segmented_sum_scan(*args))
                                                  for _ in range(3)])),
                          "bound_ms": 1e3 * 2 * args[0].numel() * 4 / PEAK_BYTES_S}
            elif name == "scatter_set_rows":
                table, rows, ids = args
                want = scatter_set_rows_plain(table.clone(), rows, ids)
                scatter_set_rows(table, rows, ids)
                torch.cuda.synchronize()
                if not torch.equal(table, want):
                    raise AssertionError(f"{tag} scatter_set_rows {shapes} {table.dtype} differs "
                                         f"from its plain version")
                err = 0.0
                # beside index_copy_ of the kept rows (filtered beforehand, untimed)
                timing = time_scatter(tag, table, rows, ids)
                note = f"{timing['row_bytes']}-byte {table.dtype} rows, {timing['kept']} kept"
            elif name == "requantize_rows":
                got, want = requantize_rows(*args), requantize_rows_plain(*args)
                if not torch.equal(got, want):
                    raise AssertionError(f"{tag} requantize_rows {shapes} differs from plain")
                err, note = 0.0, f"rows of {args[0].shape[1]} bytes"
            else:
                (rows,), keyed = args, kwargs
                got = stochastic_quantize_rows(rows, ids=keyed["ids"], salt=keyed["salt"])
                want = stochastic_quantize_rows_keyed_plain(rows, keyed["ids"], keyed["salt"])
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"{tag} stochastic_quantize_rows {shapes} differs")
                err, note = 0.0, "keyed"
            out.setdefault(name, {"max_abs_err": 0.0, "calls": []})
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            out[name]["calls"].append({"shapes": shapes, "note": note, **timing})
            times = (f"; {timing['ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms (bytes)"
                     if timing else "")
            if "library_ms" in timing:
                times += f", index_copy_ {timing['library_ms']:.4f} ms"
            print(f"{tag} {name} kernel vs plain {shapes} ({note}): max abs err {err:.3e}{times}")
    return out


def phase41_path(spec: ModelSpec, table: str, leaves: dict, rng: np.random.Generator, seed: int,
                 calls: dict, optimizer: str = "adam", precision: Optional[str] = None,
                 host: Optional[list] = None):
    """One phase-41 training path: the trainer from ``leaves``, one eager
    step whose update kernels' arguments are recorded (``calls``), then
    ``FORMAT_STEPS`` captured ``fit_steps`` (a warm-up step, then replays of
    a 1-step graph) with launch counts from zero, serving from the trained
    state, the captured ms/step over ``CAPTURE_TIMED`` steps of batches
    packed on the device and a profiled replay. Returns (trainer, packed
    batches, result)."""
    tag = f"[phase 41 {spec.name} {contender_name(table, optimizer)}]"
    per_step = spec.per_step[table]
    host = host or [spec.batch(rng, spec.train_rows) for _ in range(4)]
    trainer = make_trainer(spec, table, "cuda", leaves, host[0], seed, table_optimizer=optimizer,
                           matmul_precision=precision)
    addresses = {path: t.data_ptr() for path, t in trained_tables(trainer).items()}
    with recording_update_kernels(calls):
        first = float(trainer.train_step(host[0]))
    zero_counts()
    trainer.fit_steps((host[i % 4] for i in range(FORMAT_STEPS)), steps=FORMAT_STEPS,
                      log_every=FORMAT_STEPS)
    check_launches(f"{tag} fit_steps({FORMAT_STEPS})", {k: 0 for k in ALL_KERNELS},
                   {k: n * FORMAT_STEPS for k, n in per_step.items()})
    launches = names(counts())
    losses = trainer.step_losses.cpu()
    if not torch.isfinite(losses).all() or not np.isfinite(first):
        raise AssertionError(f"{tag} losses {first}, {losses.tolist()}")
    if {path: t.data_ptr() for path, t in trained_tables(trainer).items()} != addresses:
        raise AssertionError(f"{tag} a table was reallocated")
    request = {k: v[:1000] for k, v in host[1].items() if k != "label"}
    before = counts()
    scores = trainer.make_serving_fn()(request)
    torch.cuda.synchronize()
    check_launches(f"{tag} serving from the trained state", before,
                   {spec.forward_kernel: 1} if spec.forward_kernel else {})
    if scores.dtype != torch.float32 or tuple(scores.shape) != (1000,) or \
            not torch.isfinite(scores).all():
        raise AssertionError(f"{tag} serving from the trained state: {scores.dtype} "
                             f"{tuple(scores.shape)}")
    packer = trainer.batch_packer(host[0])
    packed = [tuple(t.cuda() for t in packer.pack(b)) for b in host]
    ms, host_ms = time_captured(trainer, packed, CAPTURE_TIMED, 1)
    wall, busy = profile_call(
        lambda: trainer.fit_steps(iter(packed[:1]), steps=1, log_every=1),
        f"{tag} one captured step", per_step, top=8)
    tables = {path: [list(t.shape), str(t.dtype).replace("torch.", "")]
              for path, t in trained_tables(trainer).items()}
    print(f"{tag} {FORMAT_STEPS} captured steps at batch {spec.train_rows}, launches {launches}; "
          f"losses {first:.6f} -> {float(losses[-1]):.6f}; {ms:.3f} ms/step (CUDA events over "
          f"{CAPTURE_TIMED} captured steps), host clock {host_ms:.3f}; tables "
          f"{dict(list(tables.items())[:3])}{' ...' if len(tables) > 3 else ''}")
    return trainer, packed, {"launches": launches, "ms_per_step": ms, "host_ms_per_step": host_ms,
                             "replay_device_ms": busy,
                             "replay_busy": None if busy is None else busy / wall,
                             "batch": spec.train_rows, "tables": len(tables),
                             "table_shapes": dict(list(tables.items())[:3])}


def bytes_equal_f32(tag: str, f32, as_bytes) -> None:
    """The byte-row trainer against the f32 one after the same steps from
    the same state: every loss, table field and dense parameter bit-equal."""
    path = TABLES["f32"]
    c = 3 * EMB
    if not torch.equal(as_bytes.state.packed[path].view(torch.float32)[:, :c],
                       f32.state.packed[path][:, :c]):
        raise AssertionError(f"{tag} the byte rows' fields differ from the f32 rows'")
    theirs = as_bytes.model.state_dict()
    for key, value in f32.model.state_dict().items():
        if key.replace(".", "/") != path and not torch.equal(value, theirs[key]):
            raise AssertionError(f"{tag} {key} differs")
    # the recorded eager step, fit_steps, the timed and profiled steps, the rounds
    steps = 1 + FORMAT_STEPS + CAPTURE_TIMED + 1 + FORMAT_ROUNDS * CAPTURE_TIMED
    print(f"{tag} bytes/adam against f32/adam after the same {steps} steps from one state: "
          f"every table field and dense parameter bit-equal")


def format_contenders(rng: np.random.Generator, seed: int, calls: dict) -> dict:
    """Phase 41's third part: each of ``CONTENDERS`` at ``scripts/
    packed_bytes_ab.py``'s configuration through ``phase41_path`` over the
    same host batches, from the same rows (``format_leaves``); then
    ``FORMAT_ROUNDS`` interleaved rounds of ``CAPTURE_TIMED`` captured steps
    each; bytes/adam against f32/adam bit for bit."""
    base = flax_leaves(np.random.default_rng(seed + 41), "f32")
    host = [FORMATS_SPEC.batch(rng, TRAIN_BATCH) for _ in range(4)]
    runs = {}
    for table, optimizer in CONTENDERS:
        name = contender_name(table, optimizer)
        leaves = format_leaves(base, table, optimizer)
        trainer, packed, out = phase41_path(FORMATS_SPEC, table, leaves, rng, seed, calls,
                                            optimizer, CONTENDER_PRECISION, host)
        runs[name] = (trainer, packed, out)
        out["row_bytes"] = trainer.state.packed[TABLES["f32"]][0].nbytes
        out["round_ms"] = []
    for _ in range(FORMAT_ROUNDS):
        for name, (trainer, packed, out) in runs.items():
            out["round_ms"].append(time_captured(trainer, packed, CAPTURE_TIMED, 1)[0])
    bytes_equal_f32("[phase 41 formats]", runs["f32/adam"][0], runs["bytes/adam"][0])
    results = {name: out for name, (_, _, out) in runs.items()}
    ranked = sorted(results, key=lambda n: float(np.median(results[n]["round_ms"])))
    print("[phase 41 formats] ms/step by contender (CUDA events, rounds "
          + ", ".join(f"{n} {results[n]['row_bytes']} B rows: "
                      + " / ".join(f"{ms:.3f}" for ms in [results[n]['ms_per_step'],
                                                         *results[n]['round_ms']])
                      for n in ranked) + ")")
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return {"contenders": results, "ranked": ranked, "bytes_bit_equal_f32": True}


def dlrm_phase(rng: np.random.Generator, seed: int) -> dict:
    """Phase 41: DLRM served captured at 1, 256 and 4096 rows with the f32 and
    int8 tables, then trained captured with the f32, int8 and classic tables
    and with per-field unpacked tables (lazy Adam; rowwise Adagrad's one
    recorded step adds the accumulator's 4-byte rows); the seven format
    contenders; a stepped card-against-CPU check for per-field unpacked
    Adam and for bf16 rows at batch 512; every recorded update kernel
    against its plain version."""
    t0 = time.perf_counter()
    out, calls = {}, {}
    requests = make_requests(rng, DLRM_REQUESTS, candidates=False)
    zero_counts()
    served = sum(serve_table(DLRM_SPEC, table, requests, seed, profiled=())
                 for table in ("f32", "int8"))
    check_launches("DLRM serving", {k: 0 for k in ALL_KERNELS}, {})
    out["served"] = served
    torch.cuda.empty_cache()
    for offset, table in enumerate(("f32", "int8", "classic", "per_field")):
        leaves = dlrm_leaves(np.random.default_rng(seed + 42 + offset), table)
        trainer, _, out[f"dlrm_{table}"] = phase41_path(DLRM_SPEC, table, leaves, rng, seed, calls)
        if table == "per_field":
            if trainer.rows_injection is not False or trainer.state.packed:
                raise AssertionError("[phase 41 dlrm per_field] want unpacked tables, injected "
                                     "through injection_specs")
            # rowwise Adagrad's [V] accumulators: B4 on 4-byte rows, one recorded step
            rowwise = make_trainer(DLRM_SPEC, table, "cuda", leaves,
                                   DLRM_SPEC.batch(rng, TRAIN_BATCH), seed,
                                   table_optimizer="rowwise_adagrad")
            with recording_update_kernels(calls):
                rowwise.train_step(DLRM_SPEC.batch(rng, TRAIN_BATCH))
            del rowwise
        del trainer, leaves
        gc.collect()
        torch.cuda.empty_cache()
    out["formats"] = format_contenders(rng, seed, calls)
    leaves = dlrm_leaves(np.random.default_rng(seed + 46), "per_field")
    stepped_card_against_cpu(DLRM_SPEC, "per_field", leaves, rng, seed)
    leaves = format_leaves(flax_leaves(np.random.default_rng(seed + 47), "f32"), "bf16", "adam")
    stepped_card_against_cpu(FORMATS_SPEC, "bf16", leaves, rng, seed)
    del leaves
    torch.cuda.empty_cache()
    out["against_plain"] = update_kernels_against_plain(calls)
    del calls
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 41: DLRM and the table formats in {out['seconds']:.1f} s")
    return out


# phase 42: the normal entry point (console_main, Task.from_config, the
# harnesses, the registries' optimizers, the profiler) on bench.py's Criteo
# shape with the planted conversion funnel
TASKS_DATA = dict(FILES_CTR, with_conversion=True)
TASKS_CUT_ROWS = 131_072  # the repeat, grid-search and profiler runs' cut
TASKS_READER = dict(split_mode=SplitMode.SEQUENTIAL_SPLIT, warm_n=1, vt_ratio=0.1,
                    train_mode=TrainMode.POINT_WISE)
TASKS_LR = 1e-2  # Adam's lr, as phase 39's: the AUC gates need 1 epoch to learn
MULTITASK_METRICS = ["auc/0", "auc/1"]
# console_main's arguments of every CLI run: DCN-v2 at bench.py's width
TASKS_ARGV = ["--epoch", "1", "--batch_size", str(TRAIN_BATCH), "--optimizer", "adam",
              "--lr", str(TASKS_LR), "--split_mode", "sequential_split", "--reader", "warm_n=1",
              "--reader", "vt_ratio=0.1", "--verbose", "0", "--model", f"emb_size={EMB}",
              "--model", f"num_cross_layers={CROSS_LAYERS}", "--model", f"layers={MLP_UNITS}",
              "--model_name", "dcnv2", "--metrics", "auc,logloss", "--device", "cuda"]
CLI_RUNS = {"cli_dcnv2_auto": [],  # the dense Trainer over 26 per-field f32 tables
            "cli_dcnv2_sparse": ["--trainer", "sparse", "--model", "unified_embedding=True"]}
# a sparse (packed f32), int8 packed or classic step's kernels, each table a step
TABLE_STEP = {"sparse": {segmented_sum_scan: 1, scatter_set_rows: 1},
              "int8": {segmented_sum_scan: 1, requantize_rows: 1, scatter_set_rows: 1},
              "classic": {segmented_sum_scan: 1, stochastic_quantize_rows: 1,
                          scatter_set_rows: 2}}
MULTITASK_RUNS = {  # name -> (model, trainer route, table, model kwargs, loss)
    "shared_bottom": ("shared_bottom", "sparse", "sparse", {}, "bce"),
    "mmoe": ("mmoe", "sparse", "sparse", {}, "bce"),
    "ple": ("ple", "sparse", "sparse", {}, "bce"),
    "esmm": ("esmm", "sparse", "sparse", {}, "esmm"),
    "mmoe_int8": ("mmoe", "auto", "int8", dict(quantized_embedding=True, table_packed=True),
                  "bce"),
    "mmoe_classic": ("mmoe", "auto", "classic", dict(quantized_embedding=True), "bce"),
}
NEW_OPTIMIZERS = {"adagrad": dict(optimizer="adagrad"),
                  "adamw": dict(optimizer="adamw", weight_decay=1e-4),
                  "adam_clip": dict(optimizer="adam", grad_clip_norm=1.0)}
OPTIMIZER_STEPS = 8  # eager steps against 4 + 4 captured (1, then 4 a replay)
MMOE_LAYERS = dict(n_experts=4, expert_layers=(128, 64), tower_layers=(64,))
CONVERSION = CategoricalColumnWithIdentity(feature_name="conversion", category_num=2)


@contextlib.contextmanager
def recorded_tasks(runs: list):
    """Every ``Task.run`` in the block appends ``(task, its result)`` to
    ``runs`` (the CLI builds its tasks itself)."""
    run = Task.run

    def recording(task):
        result = run(task)
        runs.append((task, result))
        return result

    Task.run = recording
    try:
        yield runs
    finally:
        Task.run = run


def task_checked(tag: str, task, result, per_step: dict, scoring: Optional[Any],
                 gates: tuple, work_dir: str) -> dict:
    """One Task's run, its launches counted from zero before it: ``(best
    epoch, dev logs, test logs)``, every step's loss finite, each gated
    metric above 0.5 on dev and test, the log and model files written, and
    each kernel launched ``per_step`` times a step (``scoring``: once a
    scoring batch). Then one more epoch (no dev), timed by CUDA events, and
    the captured step alone over device-resident batches (``time_captured``,
    ``CAPTURE_TIMED`` steps) and one profiled replay (``profile_call``)."""
    best_epoch, dev, test = result
    reader, batch = task.data_reader, task.batch_size
    sizes = {split: reader.get_dataset_size(split) for split in ("train", "dev", "test")}
    steps = sizes["train"] // batch
    scored = -(-sizes["dev"] // batch) + -(-sizes["test"] // batch)
    want = {k: n * steps for k, n in per_step.items()}
    if scoring is not None:
        want[scoring] = want.get(scoring, 0) + scored
    check_launches(f"{tag} Task.run ({steps} steps, {scored} scoring batches)",
                   {k: 0 for k in ALL_KERNELS}, want)
    launches = names(counts())
    losses = task.trainer.step_losses
    if best_epoch != 0 or len(losses) != steps or not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{tag} best epoch {best_epoch}, {len(losses)} losses for {steps} "
                             f"steps, finite {bool(torch.isfinite(losses).all())}")
    for metric in gates:
        if not (dev[metric] > 0.5 and test[metric] > 0.5):
            raise AssertionError(f"{tag} {metric}: dev {dev[metric]}, test {test[metric]}; "
                                 f"both must be above 0.5")
    files = [os.path.join(work_dir, "Log", f"{task.filename}{suffix}")
             for suffix in (".csv", ".test.csv")]
    files.append(os.path.join(work_dir, "Model", f"{task.filename}.pt"))
    missing = [f for f in files if not os.path.getsize(f)]
    if missing:
        raise AssertionError(f"{tag} empty files {missing}")
    ms, host_ms = time_fit(lambda: task.trainer.fit(reader, batch_size=batch, epochs=1,
                                                    verbose=0, seed=task.random_seed + 1,
                                                    eval_dev=False), steps)
    # the captured step alone: fit_steps over 4 train batches packed on the
    # device (fit's layout, so its graph replays), 4 steps of warm-up
    packer = task.trainer.batch_packer(reader.get_batch("train", np.arange(batch)))
    packed = [tuple(t.cuda() for t in packer.pack(
        reader.get_batch("train", np.arange(i * batch, (i + 1) * batch)))) for i in range(4)]
    time_captured(task.trainer, packed, 4, 1)
    captured_ms, _ = time_captured(task.trainer, packed, CAPTURE_TIMED, 1)
    print(f"{tag} {type(task.trainer).__name__}: best epoch {best_epoch}, dev {dev}, test "
          f"{test}; launches {launches} ({steps} steps, {scored} scoring batches of {batch}); "
          f"files {[os.path.basename(f) for f in files]}; one more epoch {ms:.3f} ms/step "
          f"(CUDA events; host {host_ms:.3f}); the captured step over device batches "
          f"{captured_ms:.3f} ms/step")
    wall, busy = profile_call(
        lambda: task.trainer.fit_steps(iter(packed[:1]), steps=1, log_every=1),
        f"{tag} one captured step", per_step, top=8)
    return {"trainer": type(task.trainer).__name__, "best_epoch": best_epoch, "dev": dev,
            "test": test, "steps": steps, "batch": batch, "rows": sizes,
            "ms_per_step": ms, "host_ms_per_step": host_ms, "captured_ms_per_step": captured_ms,
            "replay_device_ms": busy, "replay_busy": None if busy is None else busy / wall,
            "launches": launches}


def cli_runs(seed: int, work_dir: str) -> dict:
    """Phase 42's CLI: ``console_main.main`` in process, DCN-v2 at bench.py's
    width, once under the dense Trainer and once under the sparse trainer."""
    out = {}
    for name, extra in CLI_RUNS.items():
        tag = f"[tasks {name}]"
        runs = []
        zero_counts()
        t0 = time.perf_counter()
        with recorded_tasks(runs):
            code = console_main.main(["--dataset", "Tasks-ctr", "--random_seed", str(seed),
                                      *TASKS_ARGV, *extra])
        seconds = time.perf_counter() - t0
        if code != 0 or len(runs) != 1:
            raise AssertionError(f"{tag} console_main returned {code} after {len(runs)} tasks")
        (task, result), = runs
        per_step = {cross_network: 1, **(TABLE_STEP["sparse"] if extra else {})}
        out[name] = task_checked(tag, task, result, per_step, cross_network, ("auc",), work_dir)
        out[name]["seconds"] = seconds
        del task, runs
        gc.collect()
        torch.cuda.empty_cache()
    return out


def multitask_runs(seed: int, work_dir: str) -> dict:
    """Phase 42's multi-task family through ``Task.from_config``: the JAX
    defaults at E=16 on the unified table, the sparse trainer; MMoE also
    with the int8 packed and the classic table (the ``auto`` route)."""
    out = {}
    for name, (model, route, table, extra, loss) in MULTITASK_RUNS.items():
        tag = f"[tasks {name}]"
        zero_counts()
        t0 = time.perf_counter()
        task = Task.from_config(model, "Tasks-ctr", reader_kwargs=TASKS_READER,
                                model_kwargs=dict(emb_size=EMB, unified_embedding=True, **extra),
                                device="cuda", random_seed=seed, metrics=MULTITASK_METRICS,
                                epoch=1, batch_size=TRAIN_BATCH, lr=TASKS_LR, loss=loss,
                                trainer=route, verbose=0)
        result = task.run()
        seconds = time.perf_counter() - t0
        out[name] = task_checked(tag, task, result, TABLE_STEP[table], None,
                                 tuple(MULTITASK_METRICS), work_dir)
        out[name]["seconds"] = seconds
        del task
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mmoe_leaves(rng: np.random.Generator, table: str) -> dict:
    """Random MMoE parameters (``MMOE_LAYERS`` over bench.py's fields) in the
    flax leaf layout: kernels and expert weights N(0, 2 / fan_in), biases
    N(0, 0.01), the packed f32 ``[V, 64]`` table leaf with rows N(0, 0.1)
    (ten times the init's, as ``din_leaves`` says why)."""
    dim = N_SPARSE * EMB + N_DENSE
    leaves = {}
    width = dim
    for i, units in enumerate(MMOE_LAYERS["expert_layers"]):
        leaves[f"experts/w_{i}"] = np.stack([he_leaf(rng, width, units)
                                             for _ in range(MMOE_LAYERS["n_experts"])])
        leaves[f"experts/b_{i}"] = normal_leaf(rng, MMOE_LAYERS["n_experts"], units)
        width = units
    for t in range(2):
        leaves[f"gate_{t}/kernel"] = he_leaf(rng, dim, MMOE_LAYERS["n_experts"])
        tower_in = width
        for i, units in enumerate(MMOE_LAYERS["tower_layers"]):
            leaves[f"tower_{t}/Dense_{i}/Dense_0/kernel"] = he_leaf(rng, tower_in, units)
            leaves[f"tower_{t}/Dense_{i}/Dense_0/bias"] = normal_leaf(rng, units)
            tower_in = units
        leaves[f"head_{t}/kernel"] = he_leaf(rng, tower_in, 1)
        leaves[f"head_{t}/bias"] = normal_leaf(rng, 1)
    rows = normal_leaf(rng, N_SPARSE * VOCAB, EMB) * np.float32(10.0)
    leaves["unified_emb/embedding"] = packed_f32_leaf(rows, PACKED_W)
    return leaves


def make_mmoe(table: str, device, seed: int) -> MMoE:
    sparse = [CategoricalColumnWithIdentity(feature_name=f"c_{i}", category_num=VOCAB)
              for i in range(N_SPARSE)]
    dense = [NumericColumn(feature_name=f"d_{i}") for i in range(N_DENSE)]
    return MMoE(sparse_columns=sparse, dense_columns=dense, label_column=LABEL,
                task_columns=(LABEL, CONVERSION), emb_size=EMB, unified_embedding=True,
                device=device, generator=torch.Generator(device=device).manual_seed(seed),
                **MMOE_LAYERS)


def make_mmoe_batch(rng: np.random.Generator, rows: int = TRAIN_BATCH) -> dict:
    """``make_train_batch`` with a conversion label under each click."""
    batch = make_train_batch(rng, rows)
    batch["conversion"] = (batch["label"] * rng.integers(0, 2, size=rows)).astype(np.int32)
    return batch


MMOE_SPEC = dataclasses.replace(
    DCNV2_SPEC, name="mmoe", make=make_mmoe, leaves=mmoe_leaves, batch=make_mmoe_batch,
    forward_kernel=None, plain_forward=None, per_step={"f32": TABLE_STEP["sparse"]},
    cpu_rows=512)


def optimizer_run(name: str, leaves: dict, rng: np.random.Generator, seed: int) -> dict:
    """One of the new optimizers on DCN-v2 at bench.py's shape (the sparse
    trainer's packed f32 table; the optimizer takes the dense parameters):
    8 eager ``train_step``s against ``fit_steps(4, steps_per_call=1)`` then
    ``fit_steps(4, steps_per_call=4)`` from the same state over the same
    batches, launch counts from zero for each, every loss, dense parameter,
    table value and optimizer value bit-equal; then the card against the
    CPU from a common state (``stepped_card_against_cpu``)."""
    tag = f"[tasks optimizer {name}]"
    compiled = NEW_OPTIMIZERS[name]
    per_step = DCNV2_SPEC.per_step["f32"]
    host = [make_train_batch(rng) for _ in range(4)]
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()} for b in host]
    eager, captured = (make_trainer(DCNV2_SPEC, "f32", "cuda", leaves, host[0], seed, **compiled)
                       for _ in range(2))
    n = OPTIMIZER_STEPS
    zero_counts()
    eager_losses = torch.stack([eager.train_step(batches[i % 4]) for i in range(n)])
    check_launches(f"{tag} {n} eager steps", {k: 0 for k in ALL_KERNELS},
                   {k: v * n for k, v in per_step.items()})
    zero_counts()
    captured.fit_steps((host[i % 4] for i in range(n // 2)), steps=n // 2, log_every=n)
    first = captured.step_losses.clone()
    captured.fit_steps((host[i % 4] for i in range(n // 2, n)), steps=n // 2, log_every=n,
                       steps_per_call=4)
    check_launches(f"{tag} fit_steps {n // 2} + {n // 2}", {k: 0 for k in ALL_KERNELS},
                   {k: v * n for k, v in per_step.items()})
    launches = names(counts())
    losses = torch.cat([first, captured.step_losses])
    differ = captured_values_agree(tag, DCNV2_SPEC, "f32", eager, captured)
    if not torch.equal(losses, eager_losses):
        differ.append("loss")
    theirs = captured.state.optimizer.state
    by_name = dict(captured.model.named_parameters())
    for param_name, param in eager.model.named_parameters():
        for key, value in eager.state.optimizer.state.get(param, {}).items():
            if not torch.equal(value, theirs[by_name[param_name]][key]):
                differ.append(f"{param_name} {key}")
    if differ or not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{tag} captured against eager: {differ} differ (losses finite "
                             f"{bool(torch.isfinite(losses).all())})")
    print(f"{tag} {n} steps eager and captured (graphs of {sorted(captured._graphs)} steps): "
          f"every loss, dense parameter, table and optimizer value bit-equal; losses "
          f"{float(losses[0]):.6f} -> {float(losses[-1]):.6f}; launches {launches}")
    del eager, captured, batches
    gc.collect()
    torch.cuda.empty_cache()
    stepped_card_against_cpu(DCNV2_SPEC, "f32", leaves, rng, seed, **compiled)
    gc.collect()
    torch.cuda.empty_cache()
    return {"compiled": compiled, "steps": n, "bit_equal": True, "launches": launches,
            "losses": [float(losses[0]), float(losses[-1])]}


def harness_runs(seed: int, work_dir: str) -> dict:
    """Phase 42's other entry points on a cut of the data: ``RepeatTask``
    (2 repeats) and ``GridSearch`` (2 lr values) through ``console_main``,
    each writing its TSV of one row a run; and one ``fit`` under
    ``TorchProfiler``, whose trace must hold CUDA kernels."""
    out = {}
    argv = ["--dataset", "Tasks-cut", "--random_seed", str(seed), *TASKS_ARGV, "--trainer",
            "sparse", "--model", "unified_embedding=True"]
    harnesses = {"repeat": (["--task_name", "repeat", "--repeat_num", "2"],
                            os.path.join(work_dir, "RepeatTask",
                                         "dcnv2_Tasks-cut_bce_repeat_2.csv")),
                 "grid_search": (["--task_name", "grid_search", "--grid_lr", "0.01,0.001"],
                                 os.path.join(work_dir, "GridSearch",
                                              "dcnv2_Tasks-cut_bce_grid_search.csv"))}
    for name, (task_argv, path) in harnesses.items():
        tag = f"[tasks {name}]"
        runs = []
        zero_counts()
        t0 = time.perf_counter()
        with recorded_tasks(runs):
            code = console_main.main([*task_argv, *argv])
        seconds = time.perf_counter() - t0
        launches = names(counts())
        with open(path, newline="") as f:
            table = list(csv.reader(f, delimiter="\t"))
        header, rows = table[0], table[1:]
        aucs = [float(r[header.index("test_auc")]) for r in rows]
        steps = sum(len(task.trainer.step_losses) for task, _ in runs)
        if (code != 0 or len(runs) != 2 or len(rows) != 2 or header[0] != ""
                or not np.isfinite(aucs).all()
                or launches["segmented_sum_scan"] != steps):
            raise AssertionError(f"{tag} code {code}, {len(runs)} tasks, table {table}, "
                                 f"launches {launches} for {steps} steps")
        print(f"{tag} console_main: {len(runs)} tasks in {seconds:.1f} s, {path} holds "
              f"{header} and {len(rows)} rows, test AUC {aucs}; launches {launches}")
        out[name] = {"seconds": seconds, "columns": header[1:], "test_auc": aucs,
                     "launches": launches}
        del runs
        gc.collect()
        torch.cuda.empty_cache()

    task = Task.from_config("dcnv2", "Tasks-cut", reader_kwargs=TASKS_READER,
                            model_kwargs=dict(emb_size=EMB, unified_embedding=True),
                            device="cuda", trainer="sparse")
    task.trainer.compile(optimizer="adam", lr=TASKS_LR, metrics=("auc",))
    profiler = TorchProfiler(os.path.join(work_dir, "trace"), start_batch=1, num_batches=2)
    task.trainer.fit(task.data_reader, batch_size=TRAIN_BATCH, epochs=1, verbose=0,
                     callbacks=[profiler], eval_dev=False)
    with open(profiler.trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    if not kernels:
        raise AssertionError(f"[tasks profiler] no CUDA kernel in {profiler.trace_path}")
    out["profiler"] = {"bytes": os.path.getsize(profiler.trace_path), "events": len(events),
                       "kernel_events": kernels}
    print(f"[tasks profiler] TorchProfiler over batches 1-2: {out['profiler']}")
    del task
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tasks_phase(rng: np.random.Generator, seed: int) -> dict:
    """Phase 42: the dataset generated in a temporary work dir
    (``PYTORCHREC_TPU_WORK_DIR``, removed at the end), then ``cli_runs``,
    ``multitask_runs``, MMoE card against CPU, ``optimizer_run`` for each
    new optimizer and ``harness_runs``."""
    t0 = time.perf_counter()
    previous = os.environ.get("PYTORCHREC_TPU_WORK_DIR")
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.environ["PYTORCHREC_TPU_WORK_DIR"] = tmp
            t1 = time.perf_counter()
            generate_synthetic_ctr("Tasks-ctr", **TASKS_DATA)
            generate_synthetic_ctr("Tasks-cut", **dict(TASKS_DATA, n_rows=TASKS_CUT_ROWS))
            out["generate_s"] = time.perf_counter() - t1
            out.update(cli_runs(seed, tmp))
            out.update(multitask_runs(seed, tmp))
            stepped_card_against_cpu(MMOE_SPEC, "f32",
                                     mmoe_leaves(np.random.default_rng(seed + 42), "f32"), rng,
                                     seed)
            leaves = flax_leaves(np.random.default_rng(seed + 43), "f32")
            out["optimizers"] = {name: optimizer_run(name, leaves, rng, seed)
                                 for name in NEW_OPTIMIZERS}
            del leaves
            out.update(harness_runs(seed, tmp))
    finally:
        if previous is None:
            os.environ.pop("PYTORCHREC_TPU_WORK_DIR", None)
        else:
            os.environ["PYTORCHREC_TPU_WORK_DIR"] = previous
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 42: the entry point's runs in {out['seconds']:.1f} s")
    return out

# phase 43: the serving export, scored by the Python-free server
BUNDLE_NAMES = ("dcnv2_int8", "dcnv2_f32_dense", "deepfm_f32", "din_f32")
BUNDLE_REPS = 50  # server runs (and captured requests) timed after the checked one
BUNDLE_STEPS = 5  # captured train steps before the export: a warm-up, then 2 replays of 2
BUNDLE_TRAIN_ROWS = 4096  # the dense Trainer's training batch (the 1-row bundle's model)
LOAD_RTOL, LOAD_ATOL = 1e-6, 1e-9  # load_serving against the live scorer
SERVER_TIMEOUT_S = 600


def bundle_trainer(name: str, rng: np.random.Generator, seed: int):
    """(trainer, spec, table, request) of one phase-43 bundle, its model
    trained ``BUNDLE_STEPS`` captured steps from weights made from ``seed``."""
    if name == "dcnv2_int8":
        spec, table, rows = DCNV2_SPEC, "int8", TRAIN_BATCH
    elif name == "deepfm_f32":
        spec, table, rows = DEEPFM_SPEC, "f32", TRAIN_BATCH
    elif name == "din_f32":
        spec, table, rows = DIN_SPEC, "f32", None
    else:  # dcnv2_f32_dense: the dense Trainer over the model's own f32 table, 1 row
        spec, table, rows = DCNV2_SPEC, "f32", 1
    if name == "dcnv2_f32_dense":
        host = [make_train_batch(rng, BUNDLE_TRAIN_ROWS) for _ in range(2)]
        trainer = Trainer(make_ctr(DCNv2, "f32", "cuda", seed), device="cuda")
        trainer.compile(optimizer="adam", lr=TRAIN_LR, loss="bce", metrics=())
        trainer.init_state(host[0], seed=seed)
        per_step = {cross_network: 1}
    else:
        host = [spec.batch(rng, spec.train_rows) for _ in range(2)]
        trainer = make_trainer(spec, table, "cuda", spec.leaves(rng, table), host[0], seed,
                               metrics=())
        per_step = spec.per_step[table]
    before = counts()
    trainer.fit_steps((host[i % 2] for i in range(BUNDLE_STEPS)), steps=BUNDLE_STEPS,
                      log_every=BUNDLE_STEPS, steps_per_call=2)
    check_launches(f"[phase 43 {name}] fit_steps({BUNDLE_STEPS})", before,
                   {k: n * BUNDLE_STEPS for k, n in per_step.items()})
    if not torch.isfinite(trainer.step_losses).all():
        raise AssertionError(f"[phase 43 {name}] losses {trainer.step_losses.tolist()}")
    if rows is None:
        request = make_din_requests(rng)[-1][1]  # [1024, 100] candidates
    else:
        request = make_requests(rng, (rows,), candidates=False)[0][1]
    return trainer, spec, request


def timed_ms(fn, label: str, want: dict, repeats: int = BUNDLE_REPS) -> dict:
    """``repeats`` calls of ``fn``, each to a synchronize, on the host clock,
    each launching what ``want`` says: median and p90 ms."""
    times = []
    for _ in range(repeats):
        before = counts()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        check_launches(label, before, want)
    return {"median_ms": float(np.median(times)), "p90_ms": float(np.percentile(times, 90))}


def run_server(shim: str, bundle: str, label: str) -> dict:
    """The server on ``bundle`` as a subprocess (no Python in it): exit 0,
    scores within the manifest's tolerance and each op's launches equal to
    (1 + BUNDLE_REPS) times its launches a request (the server checks both
    and prints its RESULT line)."""
    run = subprocess.run([shim, bundle, "--reps", str(BUNDLE_REPS)], capture_output=True,
                         text=True, timeout=SERVER_TIMEOUT_S)
    print("\n".join(f"{label} server: {line}" for line in run.stdout.splitlines()))
    if run.returncode != 0 or "SERVING VERIFICATION PASSED" not in run.stdout:
        raise AssertionError(f"{label} the server exited {run.returncode}: {run.stderr[-2000:]}")
    return json.loads(next(line for line in run.stdout.splitlines()
                           if line.startswith("RESULT "))[len("RESULT "):])


def serving_bundle_phase(rng: np.random.Generator, seed: int, builds) -> dict:
    """Phase 43: four bundles exported on the card, each path's launches
    from zero: DCN-v2 with packed int8 tables at 32768 rows (B1's fused form,
    the in-graph dequantize), DCN-v2 f32 under the dense ``Trainer`` at 1
    row (B1's rows tile), DeepFM f32 packed at 32768 rows (B6's forward) and
    DIN f32 packed at ``[1024, 100]`` (B5). Each model is trained
    ``BUNDLE_STEPS`` captured steps; ``export_serving_bundle`` writes the
    AOTInductor package, the ops library, the kept inputs and the live
    scorer's scores; the server scores it with no Python (``run_server``);
    ``load_serving`` of ``export_serving``'s file scores the same request
    within LOAD_RTOL of the live scorer and launches the kernel once; the
    captured ``make_serving_fn`` request at the same shape (device-resident
    inputs, as the server's) is timed beside the server. ``builds`` is the
    future of the ops library's and the server's build, started in phase 2."""
    t0 = time.perf_counter()
    build_s = builds.result()
    shim = shim_binary_path()
    out = {"build_s": build_s}
    forward = dict(zip(BUNDLE_NAMES, (cross_network, cross_network, fm_interaction,
                                      din_attention_pool)))
    forms = {}
    for name, kernel in forward.items():
        tag = f"[phase 43 {name}]"
        zero_counts()
        trainer, spec, request = bundle_trainer(name, rng, seed)
        shape = tuple(np.asarray(request[spec.scored_key]).shape)
        if kernel is cross_network:
            rows = int(np.prod(shape))
            forms[name] = plan_name(rows, DIM)
        with tempfile.TemporaryDirectory() as tmp:
            bundle = os.path.join(tmp, "bundle")
            export_serving_bundle(trainer, request, bundle)
            with open(os.path.join(bundle, "export.json")) as f:
                exported = json.load(f)
            per_request = exported["launches_per_request"]
            if per_request != {kernel.__name__: 1}:
                raise AssertionError(f"{tag} the program launches {per_request} a request")
            server = run_server(shim, bundle, tag)
            if server["launches"] != {kernel.__name__: 1 + BUNDLE_REPS}:
                raise AssertionError(f"{tag} server launches {server['launches']}")
            package_bytes = os.path.getsize(os.path.join(bundle, "model.pt2"))
            path = os.path.join(tmp, "program.pt2")
            trainer.export_serving(path, request)
            loaded = Trainer.load_serving(path)
            live = trainer.make_serving_fn()
            want = live(request)
            before = counts()
            got = loaded(request)
            torch.cuda.synchronize()
            check_launches(f"{tag} load_serving", before, {kernel: 1})
            load_err = close(got, want, rtol=LOAD_RTOL, atol=LOAD_ATOL)
            if tuple(got.shape) != shape:
                raise AssertionError(f"{tag} load_serving scores {tuple(got.shape)}, want {shape}")
        on_card = {k: torch.as_tensor(v).cuda() for k, v in request.items()}
        live(on_card)  # the signature's eager request; the next captures
        live(on_card)
        captured = timed_ms(lambda: live(on_card), f"{tag} captured request", {kernel: 1})
        # the request as a server receives it: numpy, copied in by the scorer
        captured_host = timed_ms(lambda: live(request), f"{tag} captured host request",
                                 {kernel: 1})
        launches = names(counts())
        out[name] = {"shape": list(shape), "server": server, "captured": captured,
                     "captured_host_inputs": captured_host,
                     "package_bytes": package_bytes, "export_s": exported["export_s"],
                     "compile_s": exported["compile_s"], "load_serving_max_abs_err": load_err,
                     "python_launches": launches, "form": forms.get(name)}
        print(f"{tag} {shape}: server median {server['median_ms']:.4f} ms, p90 "
              f"{server['p90_ms']:.4f} ms; captured make_serving_fn median "
              f"{captured['median_ms']:.4f} ms, p90 {captured['p90_ms']:.4f} ms (numpy inputs: "
              f"{captured_host['median_ms']:.4f}, {captured_host['p90_ms']:.4f}; host clock, "
              f"{BUNDLE_REPS} each); server max |diff| {server['max_abs_diff']:.3e}, "
              f"load_serving max abs err {load_err:.3e}; package {package_bytes / 1e6:.1f} MB, "
              f"export {exported['export_s']:.1f} s, AOTI compile {exported['compile_s']:.1f} s"
              f"{'; B1 ' + forms[name] if name in forms else ''}; launches {launches}")
        del trainer, live, loaded, on_card
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 43: 4 bundles in {out['seconds']:.1f} s (ops library and server built in "
          f"{build_s['ops_library_s']:.1f} and {build_s['server_s']:.1f} s beside phase 2)")
    return out


def build_serving() -> dict:
    """The ops library for the card and the server, built (phase 2, beside
    the kernels): each one's seconds."""
    t0 = time.perf_counter()
    serving_ops_library(True)
    t1 = time.perf_counter()
    shim_binary_path()
    return {"ops_library_s": t1 - t0, "server_s": time.perf_counter() - t1}


# phase 45: value-based RL, scripts/rl_sparse_ab.py's DQN at full width
# under the four trainers, the sync cadence in captured windows, the card
# against the CPU and the entry point on MovieLens-1M's shape
RL_ITEMS = 1_048_576
RL_EMB = 64  # E = GRU hidden
RL_BATCH, RL_STATE, RL_NEXT = 4096, 20, 4
RL_UPDATE_FREQ = 10
RL_LR = 1e-3
RL_STEPS = 20  # captured steps timed a run, after the warm-up
RL_RUN_STEPS = 21  # captured fit_steps a run with launches from zero: a warm-up, then 20
RL_K = 4  # steps a replay
RL_EAGER_STEPS = 5
RL_ROW_SCALE = 10.0  # table rows N(0, 0.1), as DIN's (din_leaves says why)
RL_PACKED_W = 4 * RL_EMB  # f32 table || m || v || staging under Adam
RL_Q_W = packed_q_width(RL_EMB, 8, 1)  # 384 bytes
RL_TABLES = {"dense": "i_embedding/embedding", "unpacked": "i_embedding/embedding",
             "packed": "i_embedding/embedding", "int8": "i_q"}
# a train step's launches: the eval net's update ids go through B2 once and
# B4 once a scattered buffer (unpacked Adam: the table, m and v)
RL_PER_STEP = {"dense": {}, "unpacked": {segmented_sum_scan: 1, scatter_set_rows: 3},
               "packed": {segmented_sum_scan: 1, scatter_set_rows: 1},
               "int8": {segmented_sum_scan: 1, requantize_rows: 1, scatter_set_rows: 1}}
RL_CPU_ITEMS, RL_CPU_BATCH = 65_536, 512
RL_CADENCE_FREQ = 3
RL_CADENCE_WINDOWS = (1, 3, 1, 3, 1)  # steps a call: the warm-up, then windows of 3 and 1
# 100 batch-"epochs" and one dev evaluation: the smoke's time limit
RL_CLI_EPOCHS, RL_CLI_DEV_FREQ, RL_CLI_BATCH = 100, 100, 4096
RL_CLI_ARGV = ["--epoch", str(RL_CLI_EPOCHS), "--dev_freq", str(RL_CLI_DEV_FREQ),
               "--batch_size", str(RL_CLI_BATCH), "--loss", "mse", "--lr", str(RL_LR),
               "--metrics", "ndcg@10,hit@10", "--verbose", "0", "--reader",
               f"neg_sample_n={DIN_LOO - 1}", "--reader", f"max_state_len={RL_STATE}",
               "--reader", f"rl_sample_len={RL_NEXT}", "--reader", "neg_sample_mode=fast",
               "--model", f"emb_size={RL_EMB}", "--model", f"hidden_size={RL_EMB}",
               "--device", "cuda"]
# name -> (console_main's extra arguments, a step's launches)
RL_CLI_RUNS = {"cli_dqn_sparse": (["--model_name", "dqn", "--trainer", "sparse"],
                                  RL_PER_STEP["unpacked"]),
               "cli_lsrl_auto": (["--model_name", "lsrl"], {})}


def make_rl(table: str, device, seed: int, items: int = RL_ITEMS,
            update_freq: int = RL_UPDATE_FREQ) -> ValueRLModel:
    """DQN at ``scripts/rl_sparse_ab.py``'s width: a ``[items, 64]`` item
    table (int8: the packed u8 ``i_q``), GRU hidden 64, reward = label."""
    col = CategoricalColumnWithIdentity
    qnet = DQNQNet(iid_column=col(feature_name="iid", category_num=items),
                   state_column=col(feature_name="state", category_num=items),
                   state_len_column=col(feature_name="state_len", category_num=RL_STATE + 1),
                   next_state_column=col(feature_name="next_state", category_num=items),
                   next_state_len_column=col(feature_name="next_state_len",
                                             category_num=RL_STATE + 1),
                   rl_sample_column=col(feature_name="rl_sample", category_num=items),
                   emb_size=RL_EMB, hidden_size=RL_EMB, quantized_table=table == "int8",
                   device=device, generator=torch.Generator(device=device).manual_seed(seed))
    return ValueRLModel(qnet, reward_column=LABEL, gamma=0.9, update_freq=update_freq)


def make_rl_batch(rng: np.random.Generator, rows: int, items: int = RL_ITEMS) -> dict:
    """A training batch as ``scripts/rl_sparse_ab.py`` draws it."""
    return {"iid": rng.integers(0, items, size=rows).astype(np.int32),
            "state": rng.integers(1, items, size=(rows, RL_STATE)).astype(np.int32),
            "state_len": rng.integers(1, RL_STATE + 1, size=rows).astype(np.int32),
            "next_state": rng.integers(1, items, size=(rows, RL_STATE)).astype(np.int32),
            "next_state_len": rng.integers(1, RL_STATE + 1, size=rows).astype(np.int32),
            "rl_sample": rng.integers(0, items, size=(rows, RL_NEXT)).astype(np.int32),
            "label": rng.integers(0, 2, size=rows).astype(np.int32)}


def rl_leaves(rng: np.random.Generator, table: str, items: int = RL_ITEMS) -> dict:
    """Random DQN parameters in the flax leaf layout: the GRU uniform(-1/8,
    1/8), ``out`` N(0, 0.01), the item rows N(0, 0.1) as a plain ``[V, 64]``
    table (the dense and unpacked trainers), the packed ``[V, 256]`` f32
    leaf or the ``[V, 384]`` u8 ``i_q``."""
    bound = np.float32(1.0 / RL_EMB ** 0.5)
    leaves = {f"rnn/{name}": rng.uniform(-bound, bound, shape).astype(np.float32)
              for name, shape in (("w_ih", (RL_EMB, 3 * RL_EMB)), ("w_hh", (RL_EMB, 3 * RL_EMB)),
                                  ("b_ih", (3 * RL_EMB,)), ("b_hh", (3 * RL_EMB,)))}
    leaves["out/kernel"] = normal_leaf(rng, RL_EMB, RL_EMB)
    leaves["out/bias"] = normal_leaf(rng, RL_EMB)
    rows = normal_leaf(rng, items, RL_EMB) * np.float32(RL_ROW_SCALE)
    if table == "int8":
        leaves["i_q"] = packed_q_leaf(rows, RL_Q_W)
    elif table == "packed":
        leaves["i_embedding/embedding"] = packed_f32_leaf(rows, RL_PACKED_W)
    else:
        leaves["i_embedding/embedding"] = rows
    return leaves


def rl_trainer(model: ValueRLModel, table: str, device: str):
    """The trainer of a phase-45 table format."""
    if table == "dense":
        return RLTrainer(model, device=device)
    return SparseRLTrainer(model, device=device, packed_tables=table == "packed")


def rl_table_ids(path: str, batch: dict) -> np.ndarray:
    """The eval network's update ids: candidates, then the state."""
    return np.concatenate([batch["iid"].reshape(-1), batch["state"].reshape(-1)])


RL_SPEC = ModelSpec(
    name="dqn", make=make_rl, leaves=rl_leaves, batch=make_rl_batch, table_ids=rl_table_ids,
    tables=RL_TABLES, q_name="i", forward_kernel=None, plain_forward=None, per_step=RL_PER_STEP,
    train_rows=RL_BATCH, cpu_rows=RL_CPU_BATCH, cpu_request=None, emb=RL_EMB, scored_key="iid",
    loss="mse", lr=RL_LR, trainer=rl_trainer)


def rl_synced(trainer) -> bool:
    """Whether the target network equals the network, bit for bit."""
    own = trainer.model.state_dict()
    return all(torch.equal(t, own[k]) for k, t in trainer.state.target.state_dict().items())


def rl_sync_ms(trainer) -> dict:
    """The target sync alone (``torch.where`` over every target tensor, which
    a step runs whatever its flag), CUDA events, beside its bytes' bound:
    each target tensor and its source read, the target written."""
    row = torch.from_numpy(trainer.state.scalars.host_rows(RL_UPDATE_FREQ, 1)[0]).cuda()
    ms = float(np.median([time_cuda(lambda: trainer._sync_target(row), iters=20, warmup=2)
                          for _ in range(3)]))
    nbytes = sum(t.nbytes for t in trainer.state.target.state_dict().values())
    return {"ms": ms, "bound_ms": 1e3 * 3 * nbytes / PEAK_BYTES_S, "target_mb": nbytes / 1e6}


def rl_run(table: str, rng: np.random.Generator, seed: int, calls: dict, card: str) -> dict:
    """One full-width training run: the trainer from ``rl_leaves``, one eager
    step whose update kernels' arguments are recorded (``calls``), eager
    ms/step (CUDA events over device-resident batches), then
    ``RL_RUN_STEPS`` captured ``fit_steps`` (``RL_K`` a replay; the syncs of
    steps 10 and 20 fall inside replays) with launch counts from zero and
    the captured ms/step over ``RL_STEPS`` more, the sync's own time and its
    share of a captured step, and the run's peak memory above what the
    process held before it (the earlier phases' tensors and graphs)."""
    tag = f"[phase 45 dqn {table}]"
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    host = [make_rl_batch(rng, RL_BATCH) for _ in range(4)]
    leaves = rl_leaves(rng, table)
    trainer = make_trainer(RL_SPEC, table, "cuda", leaves, host[0], seed, metrics=(),
                           matmul_precision="bfloat16")
    del leaves
    addresses = {path: t.data_ptr() for path, t in trained_tables(trainer).items()}
    with recording_update_kernels(calls):
        first = float(trainer.train_step(host[0]))
    device_batches = [trainer._to_device(b) for b in host]
    eager_ms, eager_host_ms = time_eager(trainer, device_batches, RL_EAGER_STEPS)
    packer = trainer.batch_packer(host[0])
    packed = [tuple(t.cuda() for t in packer.pack(b)) for b in host]
    zero_counts()
    trainer.fit_steps((packed[i % 4] for i in range(RL_RUN_STEPS)), steps=RL_RUN_STEPS,
                      log_every=RL_RUN_STEPS, steps_per_call=RL_K)
    torch.cuda.synchronize()
    check_launches(f"{tag} fit_steps({RL_RUN_STEPS}, steps_per_call={RL_K})",
                   {k: 0 for k in ALL_KERNELS},
                   {k: n * RL_RUN_STEPS for k, n in RL_PER_STEP[table].items()})
    launches = names(counts())
    losses = trainer.step_losses.cpu()
    if not torch.isfinite(losses).all() or not np.isfinite(first):
        raise AssertionError(f"{tag} losses {first}, {losses.tolist()}")
    if {path: t.data_ptr() for path, t in trained_tables(trainer).items()} != addresses:
        raise AssertionError(f"{tag} a table was reallocated")
    steps_done = trainer.state.step
    if rl_synced(trainer) != (steps_done % RL_UPDATE_FREQ == 0):
        raise AssertionError(f"{tag} after step {steps_done} the target is "
                             f"{'' if rl_synced(trainer) else 'not '}the network")
    ms, host_ms = time_captured(trainer, packed, RL_STEPS, RL_K)
    sync = rl_sync_ms(trainer)
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
    out = {"launches": launches, "first_loss": first, "last_loss": float(losses[-1]),
           "eager_ms_per_step": eager_ms, "eager_host_ms_per_step": eager_host_ms,
           "ms_per_step": ms, "host_ms_per_step": host_ms, "sync_ms": sync["ms"],
           "sync_share": sync["ms"] / ms, "sync_bound_ms": sync["bound_ms"],
           "target_mb": sync["target_mb"], "peak_mb": peak_mb, "held_before_mb": base / 1e6,
           "tables": {path: [list(t.shape), str(t.dtype).replace("torch.", "")]
                      for path, t in trained_tables(trainer).items()}}
    print(f"{tag} {type(trainer).__name__} at batch {RL_BATCH}, {RL_ITEMS} items, E={RL_EMB}, "
          f"S={RL_STATE}, N={RL_NEXT}: {RL_RUN_STEPS} captured steps, launches {launches}; "
          f"losses {first:.6f} -> {out['last_loss']:.6f}; eager {eager_ms:.3f} ms/step (host "
          f"{eager_host_ms:.3f}), captured {ms:.3f} ms/step (host {host_ms:.3f}; CUDA events "
          f"over {RL_STEPS} steps, {RL_K} a replay); the target sync {sync['ms']:.4f} ms "
          f"({100 * out['sync_share']:.2f}% of a captured step; bound {sync['bound_ms']:.4f} ms "
          f"for {sync['target_mb']:.1f} MB of target); the run's peak memory {peak_mb:.1f} "
          f"MB above the {base / 1e6:.1f} MB held before it; tables {out['tables']}; {card}")
    del trainer, packed, device_batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rl_cadence(rng: np.random.Generator, seed: int) -> dict:
    """The sync cadence inside captured windows: DQN with the packed f32
    table at ``RL_CPU_ITEMS`` items and batch ``RL_CPU_BATCH``,
    ``update_freq=3``, two trainers from one state over the same 9 batches:
    eager ``train_step``s, whose target must equal the network bit for bit
    after steps 3, 6 and 9 and only then, and captured calls of 1 (the
    warm-up), 3, 1, 3 and 1 steps, each call's state against the eager
    trainer's after the same step (the syncs of steps 3 and 6 fall inside
    replays of the 3-step graph)."""
    tag = "[phase 45 cadence]"
    spec = dataclasses.replace(
        RL_SPEC, make=functools.partial(make_rl, items=RL_CPU_ITEMS,
                                        update_freq=RL_CADENCE_FREQ))
    host = [make_rl_batch(rng, RL_CPU_BATCH, RL_CPU_ITEMS) for _ in range(sum(RL_CADENCE_WINDOWS))]
    leaves = rl_leaves(rng, "packed", RL_CPU_ITEMS)
    eager, captured = (make_trainer(spec, "packed", "cuda", leaves, host[0], seed, metrics=())
                       for _ in range(2))
    snapshots, synced = {}, []
    for step, batch in enumerate(host, start=1):
        eager.train_step(batch)
        if rl_synced(eager):
            synced.append(step)
        snapshots[step] = (copy.deepcopy(eager.model.state_dict()),
                           copy.deepcopy(eager.state.target.state_dict()))
    want = [s for s in range(1, len(host) + 1) if s % RL_CADENCE_FREQ == 0]
    if synced != want:
        raise AssertionError(f"{tag} eager: the target equals the network after steps {synced}, "
                             f"want {want}")
    done, checked = 0, []
    zero_counts()
    for k in RL_CADENCE_WINDOWS:
        captured.fit_steps(iter(host[done:done + k]), steps=k, log_every=k, steps_per_call=k)
        done += k
        params, target = snapshots[done]
        for label, got, expected in (("network", captured.model.state_dict(), params),
                                     ("target", captured.state.target.state_dict(), target)):
            for key, value in expected.items():
                if not torch.equal(got[key], value):
                    raise AssertionError(f"{tag} after the window ending at step {done}: the "
                                         f"{label}'s {key} differs from the eager trainer's")
        if rl_synced(captured) != (done % RL_CADENCE_FREQ == 0):
            raise AssertionError(f"{tag} after step {done}: synced {rl_synced(captured)}")
        checked.append(done)
    check_launches(f"{tag} {len(host)} captured steps", {k: 0 for k in ALL_KERNELS},
                   {k: n * len(host) for k, n in RL_PER_STEP["packed"].items()})
    print(f"{tag} update_freq={RL_CADENCE_FREQ}: eager target = network after steps {synced} "
          f"only; captured calls of {list(RL_CADENCE_WINDOWS)} steps bit-equal to the eager "
          f"trainer (network and target) after steps {checked}")
    del eager, captured, snapshots
    gc.collect()
    torch.cuda.empty_cache()
    return {"eager_synced_after": synced, "windows": list(RL_CADENCE_WINDOWS),
            "checked_after": checked}


def rl_cli_runs(seed: int, work_dir: str, card: str) -> dict:
    """``console_main.main`` in process on ``FILES_ML``'s MovieLens-1M shape
    (generated once; the ``value_rl`` reader's split, negative, history,
    next-state and candidate files made by the pipeline): DQN under
    ``--trainer sparse`` (unpacked lazy Adam) and LSRL (both state branches
    and the user table) under ``auto`` (the dense ``RLTrainer``), MSE,
    ``RL_CLI_EPOCHS`` batch-"epochs" of ``RL_CLI_BATCH`` with dev NDCG@10 and
    Hit@10 every ``RL_CLI_DEV_FREQ``; each run's launches from zero, every
    loss finite, the dev and test metrics, the files written, the run's
    seconds and its captured ms/step (``time_captured`` over device-resident
    batches of the fit's layout)."""
    t0 = time.perf_counter()
    generate_synthetic_ml("RL-ML1M", **FILES_ML)
    out = {"generate_s": time.perf_counter() - t0}
    for name, (extra, per_step) in RL_CLI_RUNS.items():
        tag = f"[phase 45 {name}]"
        runs = []
        zero_counts()
        t0 = time.perf_counter()
        with recorded_tasks(runs):
            code = console_main.main(["--dataset", "RL-ML1M", "--random_seed", str(seed),
                                      *RL_CLI_ARGV, *extra])
        seconds = time.perf_counter() - t0
        if code != 0 or len(runs) != 1:
            raise AssertionError(f"{tag} console_main returned {code} after {len(runs)} tasks")
        (task, (best_epoch, dev, test)), = runs
        check_launches(f"{tag} {RL_CLI_EPOCHS} steps", {k: 0 for k in ALL_KERNELS},
                       {k: n * RL_CLI_EPOCHS for k, n in per_step.items()})
        launches = names(counts())
        losses = task.trainer.step_losses
        if len(losses) != RL_CLI_EPOCHS or not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"{tag} {len(losses)} losses, finite "
                                 f"{bool(torch.isfinite(losses).all())}")
        metrics = [dev.get(m) for m in ("ndcg@10", "hit@10")] + \
            [test.get(m) for m in ("ndcg@10", "hit@10")]
        if not all(m is not None and np.isfinite(m) for m in metrics):
            raise AssertionError(f"{tag} dev {dev}, test {test}")
        files = [os.path.join(work_dir, "Log", f"{task.filename}{suffix}")
                 for suffix in (".csv", ".test.csv")]
        files.append(os.path.join(work_dir, "Model", f"{task.filename}.pt"))
        missing = [f for f in files if not os.path.getsize(f)]
        if missing:
            raise AssertionError(f"{tag} empty files {missing}")
        reader, trainer = task.data_reader, task.trainer
        packer = trainer.batch_packer(reader.get_batch("train", np.arange(RL_CLI_BATCH)))
        packed = [tuple(t.cuda() for t in packer.pack(reader.get_batch(
            "train", np.arange(i * RL_CLI_BATCH, (i + 1) * RL_CLI_BATCH)))) for i in range(4)]
        ms, host_ms = time_captured(trainer, packed, CAPTURE_TIMED, 1)
        history = task.history.history
        out[name] = {"trainer": type(trainer).__name__, "best_epoch": best_epoch, "dev": dev,
                     "test": test, "dev_history": {m: history.get(m) for m in ("ndcg@10",
                                                                             "hit@10")},
                     "first_loss": float(losses[0]), "last_loss": float(losses[-1]),
                     "rows": {s: reader.get_dataset_size(s) for s in ("train", "dev", "test")},
                     "seconds": seconds, "ms_per_step": ms, "host_ms_per_step": host_ms,
                     "launches": launches}
        print(f"{tag} {type(trainer).__name__}: {RL_CLI_EPOCHS} steps of {RL_CLI_BATCH} in "
              f"{seconds:.1f} s (reader build included), losses {float(losses[0]):.5f} -> "
              f"{float(losses[-1]):.5f}; dev {out[name]['dev_history']} (every "
              f"{RL_CLI_DEV_FREQ} steps), best epoch {best_epoch}, test {test}; launches "
              f"{launches}; captured {ms:.3f} ms/step (host {host_ms:.3f}); {card}")
        del task, runs, reader, trainer, packed
        gc.collect()
        torch.cuda.empty_cache()
    return out


def rl_phase(rng: np.random.Generator, seed: int) -> dict:
    """Phase 45 (see the module docstring): ``rl_run`` for each trainer, each
    run's launches from zero; B2, B3 and B4 against their plain versions on
    the first eager steps' recorded arguments; ``rl_cadence``; the card
    against the CPU at ``RL_CPU_ITEMS`` items for the packed f32 and the int8
    tables (``stepped_card_against_cpu``); ``rl_cli_runs`` in a temporary
    work dir."""
    t0 = time.perf_counter()
    out, calls, card = {}, {}, card_line()
    for table in RL_TABLES:
        out[table] = rl_run(table, rng, seed, calls, card)
    out["against_plain"] = update_kernels_against_plain(calls, tag="[phase 45 kernels]")
    out["cadence"] = rl_cadence(rng, seed)
    cut = dataclasses.replace(RL_SPEC, make=functools.partial(make_rl, items=RL_CPU_ITEMS),
                              batch=functools.partial(make_rl_batch, items=RL_CPU_ITEMS))
    for table in ("packed", "int8"):
        leaves = rl_leaves(np.random.default_rng(seed + 45), table, RL_CPU_ITEMS)
        print(f"[phase 45 dqn {table}] card against CPU at {RL_CPU_ITEMS} items, batch "
              f"{RL_CPU_BATCH}")
        stepped_card_against_cpu(cut, table, leaves, rng, seed)
        gc.collect()
        torch.cuda.empty_cache()
    previous = os.environ.get("PYTORCHREC_TPU_WORK_DIR")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.environ["PYTORCHREC_TPU_WORK_DIR"] = tmp
            out["cli"] = rl_cli_runs(seed, tmp, card)
    finally:
        if previous is None:
            os.environ.pop("PYTORCHREC_TPU_WORK_DIR", None)
        else:
            os.environ["PYTORCHREC_TPU_WORK_DIR"] = previous
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 45: {len(RL_TABLES)} trainers, the kernels against plain, the cadence, 2 card "
          f"against CPU checks and {len(RL_CLI_RUNS)} CLI runs in {out['seconds']:.1f} s; "
          f"{card}")
    return out


MESH_TABLES = ("dense", "f32", "int8", "classic")  # phase 46: the dense Trainer, then the formats
MESH_RUN_STEPS = 21  # captured fit_steps a run with launches from zero: a warm-up, then 20
MESH_TIMED = 20  # captured steps timed a run, after them
MESH_RTOL = 1e-6


def mesh_trainer(table: str, mesh, leaves: dict, sample: dict, seed: int):
    """Phase 46's trainer of ``table`` (``MESH_TABLES``) at bench.py's width,
    on ``mesh`` or (None) without one, from ``leaves``: the dense
    ``Trainer`` (its unified f32 table under the dense Adam) or the format's
    table trainer, the packed transfer off on both."""
    model = make_ctr(DCNv2, "f32" if table == "dense" else table, "cuda", seed)
    if table == "dense":
        trainer = Trainer(model, mesh=mesh, packed_transfer=False)
    elif table == "f32":
        trainer = SparseEmbeddingTrainer(model, mesh=mesh, packed_tables=True)
    else:
        trainer = QuantizedEmbeddingTrainer(model, mesh=mesh, packed_tables=table == "int8")
    trainer.packed_transfer = False
    trainer.compile(optimizer="adam", lr=TRAIN_LR, loss="bce", metrics=())
    trainer.init_state(sample, seed=seed)
    return params_from_jax(leaves, trainer)


def mesh_run(table: str, mesh, leaves: dict, host: list, seed: int,
             calls: Optional[dict]) -> dict:
    """One phase-46 run: one eager step (its kernel arguments recorded into
    ``calls`` where given), ``MESH_RUN_STEPS`` captured steps with launches
    from zero, then the captured ms/step over ``MESH_TIMED`` more. Returns
    the launches, the losses, host copies of the trained tables and the
    dense parameters, and the times."""
    per_step = ({cross_network: 1} if table == "dense" else DCNV2_SPEC.per_step[table])
    tag = f"[phase 46 dcnv2 {table} {'mesh' if mesh is not None else 'no mesh'}]"
    trainer = mesh_trainer(table, mesh, leaves, host[0], seed)
    batches = [trainer._to_device(b) for b in host]
    with contextlib.ExitStack() as stack:
        if calls is not None:
            stack.enter_context(recording_update_kernels(calls))
            stack.enter_context(recording(interactions_module, "cross_network", calls))
        first = float(trainer.train_step(batches[0]))
    zero_counts()
    trainer.fit_steps((batches[i % len(batches)] for i in range(MESH_RUN_STEPS)),
                      steps=MESH_RUN_STEPS, log_every=MESH_RUN_STEPS)
    torch.cuda.synchronize()
    check_launches(f"{tag} fit_steps({MESH_RUN_STEPS})", {k: 0 for k in ALL_KERNELS},
                   {k: n * MESH_RUN_STEPS for k, n in per_step.items()})
    launches = names(counts())
    losses = torch.cat([torch.tensor([first]), trainer.step_losses.cpu()])
    if not torch.isfinite(losses).all():
        raise AssertionError(f"{tag} losses {losses.tolist()}")
    state = {path: t.detach().cpu().clone() for path, t in trained_tables(trainer).items()}
    state.update({name: p.detach().cpu().clone() for name, p in trainer.model.named_parameters()
                  if p.requires_grad})
    ms, host_ms = time_captured(trainer, batches, MESH_TIMED, 1)
    print(f"{tag} {type(trainer).__name__} at batch {TRAIN_BATCH}: {MESH_RUN_STEPS} captured "
          f"steps, launches {launches}; losses {first:.6f} -> {float(losses[-1]):.6f}; "
          f"captured {ms:.3f} ms/step (host {host_ms:.3f}; CUDA events over {MESH_TIMED} steps, "
          f"one a replay)")
    del trainer, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses, "state": state, "ms_per_step": ms,
            "host_ms_per_step": host_ms}


def largest_difference(got: torch.Tensor, want: torch.Tensor, rtol: float) -> float:
    """The largest |got - want| (f32 values; an int8 or u8 tensor's bytes
    equal), raising where one passes ``rtol * |want|`` (and 1e-30 of atol)
    or a tensor is not bit-comparable."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{got.dtype} {tuple(got.shape)} against {want.dtype} "
                             f"{tuple(want.shape)}")
    if not got.is_floating_point():
        if not torch.equal(got, want):
            raise AssertionError(f"{int((got != want).sum())} of {got.numel()} bytes differ")
        return 0.0
    return close(got.float(), want.float(), rtol=rtol, atol=1e-30)


def mesh_phase(rng: np.random.Generator, seed: int) -> dict:
    """Phase 46 (see the module docstring): for each of ``MESH_TABLES`` a run
    without the mesh and one on a ``(1, 1)`` mesh of a world of one over
    NCCL, from the same leaves and batches; their launches equal, their
    losses and tables within ``MESH_RTOL``; the kernels against their plain
    versions on the mesh runs' recorded arguments."""
    t0 = time.perf_counter()
    card, out, calls = card_line(), {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(init_method=f"file://{tmp}/store", world_size=1, rank=0,
                               timeout=datetime.timedelta(seconds=120))
        try:
            mesh = make_mesh(data=1, model=1)
            for table in MESH_TABLES:
                leaves = flax_leaves(rng, "f32" if table == "dense" else table)
                host = [make_train_batch(rng) for _ in range(4)]
                alone = mesh_run(table, None, leaves, host, seed, None)
                meshed = mesh_run(table, mesh, leaves, host, seed, calls)
                del leaves
                if meshed["launches"] != alone["launches"]:
                    raise AssertionError(f"[phase 46 {table}] launches {meshed['launches']} on the "
                                         f"mesh, {alone['launches']} without")
                loss_diff = largest_difference(meshed["losses"], alone["losses"], MESH_RTOL)
                table_diff = max(largest_difference(t, alone["state"][k], MESH_RTOL)
                                 for k, t in meshed["state"].items())
                out[table] = {"launches": meshed["launches"],
                              "ms_per_step": meshed["ms_per_step"],
                              "no_mesh_ms_per_step": alone["ms_per_step"],
                              "host_ms_per_step": meshed["host_ms_per_step"],
                              "no_mesh_host_ms_per_step": alone["host_ms_per_step"],
                              "loss_max_abs_diff": loss_diff, "state_max_abs_diff": table_diff}
                print(f"[phase 46 {table}] mesh {meshed['ms_per_step']:.3f} ms/step, no mesh "
                      f"{alone['ms_per_step']:.3f}; losses within {loss_diff:.3e}, tables and "
                      f"dense parameters within {table_diff:.3e}; launches {meshed['launches']} "
                      f"both; {card}")
                del alone, meshed
        finally:
            torch.distributed.destroy_process_group()
    x0, ws, bs = calls.pop("cross_network")
    with torch.no_grad():
        cross_err = close(cross_network(x0, ws, bs), cross_network_plain(x0, ws, bs))
    print(f"[phase 46 kernels] cross_network kernel vs plain x0 {list(x0.shape)}: max abs err "
          f"{cross_err:.3e}")
    out["against_plain"] = update_kernels_against_plain(calls, tag="[phase 46 kernels]")
    out["against_plain"]["cross_network"] = {"max_abs_err": cross_err,
                                             "calls": [{"shapes": [list(x0.shape)]}]}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 46: {len(MESH_TABLES)} pairs of runs, with and without the mesh, and the "
          f"kernels against plain in {out['seconds']:.1f} s; {card}")
    return out


# phase 47: the sharded trainer, two ranks sharing the card over gloo
SHARDED_MESH = (1, 2)  # (data, model): NCCL takes one rank a card; gloo lets two share it
SHARDED_STEPS = 20  # the Criteo runs' steps (batch CRITEO["batch"], bf16 matmuls)
CRITEO_LR = 1e-3  # the Criteo twin's Adam lr (criteo_end_to_end.make_trainer)
# The Criteo twin's command line as each rank runs it under a launcher (RANK,
# WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT set: the twin's
# rank_device picks gloo on cuda:0, the world outnumbering the cards), over
# phase 40's shards (--formatted), with the command line's bf16 matmuls
SHARDED_ARGV = ["--steps", str(SHARDED_STEPS), "--batch", str(CRITEO["batch"]),
                "--hash_bucket", str(CRITEO["hash_bucket"]), "--formatted"]
HOT_COLD_ARGV = ["--mesh", "1,2", "--hot_mass", "0.9", "--vocab_cap", "50000"]
# run -> the twin's flags after SHARDED_ARGV, or None: a path of its own.
# The plain-scan run is the hot/cold command line with B2's plain version in
# the table updates, on the two ranks and in its one-process twin (a witness,
# below)
SHARDED_RUNS = {"criteo_1d": ["--mesh", "1,2"], "criteo_hot_cold": HOT_COLD_ARGV,
                "criteo_hot_cold_plain_scan": HOT_COLD_ARGV, "grid_f32": None,
                "dlrm_int8": None}
PLAIN_SCAN_RUNS = ("criteo_hot_cold_plain_scan",)
SHARDED_KERNELS = {"criteo_1d": (cross_network, segmented_sum_scan, scatter_set_rows),
                   "criteo_hot_cold": (cross_network, segmented_sum_scan, scatter_set_rows),
                   "criteo_hot_cold_plain_scan": (cross_network, scatter_set_rows),
                   "grid_f32": (cross_network, segmented_sum_scan, scatter_set_rows),
                   "dlrm_int8": (segmented_sum_scan, requantize_rows, scatter_set_rows)}
SHARDED_RTOL = 1e-4  # ROADMAP's f32 after N steps, against the one-process run on the card
# hot/cold's fragments hold their rows in frequency order where one process
# holds them by id, so each segment of row grads sits elsewhere in B2's
# input. B2 sums a tile (512 rows at E=16) by groups of rows and carries
# across tiles: a segment's bits follow where those boundaries cut it. (The
# 1-D run's shard 1 starts 13 x 8192 rows into one process's input, a whole
# number of tiles, so it stays bit-equal.) Three witnesses: the plain-scan
# pair (B2's plain version sums by offsets from a head, the same bits at any
# place), held to SHARDED_RTOL, is the path less B2's rounding; each rank's
# first hot/cold step's B2 calls against plain and against themselves moved
# down a row and a tile (scan_position_witness); and one process with the
# kernel against one process with the plain scan, B2's rounding alone after
# the same steps. The hot/cold run's values that part from its one-process
# twin's by more than SHARDED_RTOL are measured in shares of lr (tables and
# dense leaves apart) and held to SHARDED_WITNESS_FACTOR times that last
# witness's share, its losses to SHARDED_RTOL and its held-out AUC to
# CRITEO_AUC_GAP
SHARDED_WITNESS_FACTOR = 4.0
# tests/test_sharded_quantized.py's DLRM: 3 fields of 120 ids, E=8, 5 steps of 64
SHARDED_DLRM = dict(vocab=120, fields=3, emb=8, batch=64, steps=5, lr=0.05, seed=3)
SHARDED_DEADLINE_S = 600.0  # the world's ranks are killed past it
SCAN_OWNERS = tuple(m for m in (sparse_update_module, quantized_packed_module,
                                quantized_trainer_module) if hasattr(m, "segmented_sum_scan"))


@contextlib.contextmanager
def plain_scan():
    """Inside: the table updates run B2's plain version."""
    with contextlib.ExitStack() as stack:
        for owner in SCAN_OWNERS:
            stack.enter_context(swapped(owner, "segmented_sum_scan", segmented_sum_scan_plain))
        yield


@contextlib.contextmanager
def recording_first_scans(calls: list, count: int):
    """Inside: B2 runs as before where the table updates call it, and its
    first ``count`` calls' arguments are copied into ``calls``."""
    kernel = getattr(SCAN_OWNERS[0], "segmented_sum_scan")

    def record(x, is_start):
        if len(calls) < count:
            calls.append((layout_copy(x.detach()), is_start.clone()))
        return kernel(x, is_start)

    with contextlib.ExitStack() as stack:
        for owner in SCAN_OWNERS:
            stack.enter_context(swapped(owner, "segmented_sum_scan", record))
        yield


def moved_down(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``x`` ``shift`` rows further down a zero buffer of its row stride and
    offset within a row."""
    stride, offset = x.stride(0), x.storage_offset() % x.stride(0)
    rows = torch.zeros((x.shape[0] + shift, stride), dtype=x.dtype, device=x.device)
    view = rows[:, offset:offset + x.shape[1]]
    view[shift:] = x
    return view


def scan_position_witness(tag: str, label: str, x: torch.Tensor, is_start: torch.Tensor) -> dict:
    """B2's bits against a segment's place: a recorded call against its
    plain version (as ``update_kernels_against_plain``), then its sums with
    every row moved down by one row and by one tile (rows of their own
    segments in front). The plain version gives the same bits at any place;
    the kernel gives them a tile down, and a row down it may not."""
    with torch.no_grad():
        want = segmented_sum_scan_plain(x, is_start)
        got = segmented_sum_scan(x, is_start)
        scale = max(float(want.abs().max()), 1e-30)
        err = close(got, want, rtol=1e-5, atol=1e-5 * scale)
        tile = seg_scan_launch_info(x)["tile_rows"]
        out = {"call": label, "rows": int(x.shape[0]), "tile_rows": tile, "max_abs_err": err,
               "rows_apart_from_plain": int((got != want).any(dim=1).sum())}
        for shift in (1, tile):
            moved = moved_down(x, shift)
            heads = torch.cat([is_start.new_ones(shift), is_start])
            if not torch.equal(segmented_sum_scan_plain(moved, heads)[shift:], want):
                raise AssertionError(f"{tag} {label}: the plain scan moved {shift} rows differs")
            kernel = segmented_sum_scan(moved, heads)[shift:]
            out[f"moved_{shift}"] = {"rows_apart": int((kernel != got).any(dim=1).sum()),
                                     "max_abs_diff": float((kernel - got).abs().max())}
    print(f"{tag} {label} scan {list(x.shape)}: against plain max abs err {err:.3e} "
          f"({out['rows_apart_from_plain']} rows' bits apart); moved a row "
          f"{out['moved_1']['rows_apart']} rows apart (max {out['moved_1']['max_abs_diff']:.3e}), "
          f"moved a tile ({tile} rows) {out[f'moved_{tile}']['rows_apart']}", flush=True)
    if out[f"moved_{tile}"]["rows_apart"]:
        raise AssertionError(f"{tag} {label}: B2 moved a whole tile changed its sums")
    return out


def sharded_dlrm(device) -> DLRM:
    d = SHARDED_DLRM
    sparse = tuple(CategoricalColumnWithIdentity(feature_name=f"c_{i}", category_num=d["vocab"])
                   for i in range(d["fields"]))
    return DLRM(sparse_columns=sparse, dense_columns=(NumericColumn(feature_name="d_0"),),
                label_column=LABEL, emb_size=d["emb"], bottom_layers=(16,), top_layers=(16,),
                unified_embedding=True, quantized_embedding=True, table_packed=True,
                table_row_multiple=8, device=device)


def sharded_dlrm_batches(rng: np.random.Generator) -> list:
    d = SHARDED_DLRM
    out = []
    for _ in range(d["steps"]):
        batch = {f"c_{i}": rng.integers(0, d["vocab"], size=d["batch"]).astype(np.int32)
                 for i in range(d["fields"])}
        batch["d_0"] = rng.normal(size=d["batch"]).astype(np.float32)
        batch["label"] = rng.integers(0, 2, size=d["batch"]).astype(np.int32)
        out.append(batch)
    return out


def sharded_dlrm_run(trainer, batches: list) -> tuple:
    """DLRM's int8 run: init, the steps; (losses, ms a step on the host
    clock)."""
    d = SHARDED_DLRM
    trainer.compile(optimizer="adam", lr=d["lr"], loss="bce", metrics=())
    trainer.init_state(batches[0], seed=d["seed"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(trainer.train_step(b)) for b in batches]
    return losses, (time.perf_counter() - t0) * 1e3 / len(batches)


def sharded_grid_run(mesh, data: dict) -> tuple:
    """The Criteo twin's model and batches on the grid layout (packed f32):
    (trainer, losses, the median ms a step on the host clock)."""
    batch = CRITEO["batch"]
    sparse, _, _ = criteo_twin.vocab_transform(data["train"], batch, 0, VOCAB)
    model = criteo_twin.make_model(sparse, mesh.device, mesh.model)
    trainer = ShardedSparseEmbeddingTrainer(model, mesh=mesh, strategy="grid", packed_tables=True)
    trainer.compile(optimizer="adam", lr=CRITEO_LR, loss="bce", metrics=("auc",),
                    matmul_precision="bfloat16")
    timer = StepTimer(batch_size=batch)
    trainer.fit_steps(criteo_twin.fixed_shape(criteo_twin.train_source(data, batch).batches(),
                                              batch), steps=SHARDED_STEPS, log_every=SHARDED_STEPS,
                      callbacks=[timer])
    return trainer, trainer.step_losses.cpu().numpy(), timer.stats()["p50_s"] * 1e3


def sharded_cli_run(tag: str, rank: int, name: str) -> dict:
    """A Criteo run through the twin's command line (``run_from_args`` of
    ``parse_args``), as a launcher's rank runs it: the first starts the
    process group from the environment, which must be gloo on ``cuda:0``
    (``rank_device``); rank 0 alone prints, and its held-out AUC line is
    passed on."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = criteo_twin.run_from_args(criteo_twin.parse_args(SHARDED_ARGV + SHARDED_RUNS[name]))
    device, backend = out["trainer"].mesh.device, torch.distributed.get_backend()
    if backend != "gloo" or device != torch.device("cuda", 0):
        raise AssertionError(f"{tag} the command line's group: {backend} on {device}")
    lines = printed.getvalue().splitlines()
    if rank == 0 and not any(line.startswith("held-out AUC") for line in lines):
        raise AssertionError(f"{tag} rank 0 printed {lines[-3:]}")
    if rank and lines:
        raise AssertionError(f"{tag} rank {rank} printed {lines[:3]}")
    for line in lines[-2:]:
        print(f"{tag} {line}", flush=True)
    return out


def sharded_run(name: str, rank: int, mesh, data: dict, inputs: dict, calls: dict,
                scans: list) -> dict:
    """One phase-47 run on this rank, launch counts from zero, the update
    kernels' and B1's first arguments recorded into ``calls`` (the hot/cold
    run's first B2 calls into ``scans`` too): its launches, losses,
    host-clock ms a step (the median step of the Criteo and grid runs;
    DLRM's mean after its init), held-out AUC (Criteo) and the merged
    leaves (a collective)."""
    tag = f"[phase 47 {name} rank {rank}]"
    t0 = time.perf_counter()
    zero_counts()
    with contextlib.ExitStack() as stack:
        stack.enter_context(recording_update_kernels(calls))
        stack.enter_context(recording(interactions_module, "cross_network", calls))
        if name in PLAIN_SCAN_RUNS:
            stack.enter_context(plain_scan())
        if name == "criteo_hot_cold":
            stack.enter_context(recording_first_scans(scans, 2))  # the cold shard's, the hot's
        if name == "grid_f32":
            trainer, losses, ms = sharded_grid_run(mesh, data)
            auc = None
        elif name == "dlrm_int8":
            trainer = ShardedSparseEmbeddingTrainer(sharded_dlrm(mesh.device), mesh=mesh,
                                                    packed_tables=True)
            losses, ms = sharded_dlrm_run(trainer, inputs["dlrm_batches"])
            auc = None
        else:
            out = sharded_cli_run(tag, rank, name)
            trainer, losses, auc = out["trainer"], out["step_losses"], out["heldout_auc"]
            ms = out["p50_ms"]
    launches = names(counts())
    missing = [k.__name__ for k in SHARDED_KERNELS[name] if k.launches == 0]
    if missing:
        raise AssertionError(f"{tag} {missing} launched no time; launches {launches}")
    if name in PLAIN_SCAN_RUNS and segmented_sum_scan.launches:
        raise AssertionError(f"{tag} B2 launched inside the plain scan; launches {launches}")
    if not np.isfinite(np.asarray(losses)).all():
        raise AssertionError(f"{tag} losses {losses}")
    t1 = time.perf_counter()
    merged = trainer.merged_params()
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    seconds = {"run": t1 - t0, "merge": time.perf_counter() - t1}
    print(f"{tag} {seconds['run']:.1f} s, the merged leaves {seconds['merge']:.1f} s", flush=True)
    return {"launches": launches, "losses": np.asarray(losses), "host_ms_per_step": ms,
            "heldout_auc": auc, "leaves": merged, "seconds": seconds}


def sharded_rank(rank: int, world: int, tmp: str) -> None:
    """A phase-47 rank (a process of its own, spawned by ``sharded_phase``
    with a launcher's environment): every run of ``SHARDED_RUNS`` (the
    Criteo command line starts the gloo group on ``cuda:0``; the grid and
    DLRM runs take the (1, 2) mesh on it), then B1 and the update kernels
    against their plain versions on each run's recorded arguments and B2's
    position witness. Writes its results (``result_<rank>.pt``) or its
    traceback (``error_<rank>.txt``)."""
    import traceback

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        os.environ.update({"PYTORCHREC_TPU_WORK_DIR": inputs["work_dir"], "RANK": str(rank),
                           "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                           **inputs["launcher"]})
        build("cross", "seg_scan", "scatter", "requantize")  # the parent's libraries
        t0 = time.perf_counter()
        data, out, mesh, scans = criteo_twin.formatted(), {}, None, []
        tag = f"[phase 47 kernels rank {rank}]"
        print(f"{tag} up {time.time() - inputs['spawned_at']:.1f} s after the spawn", flush=True)
        checked = {}
        for name in inputs["runs"]:
            if SHARDED_RUNS[name] is None and mesh is None:
                mesh = make_mesh(*SHARDED_MESH, device="cuda:0")  # on the command line's group
            calls = {}
            out[name] = sharded_run(name, rank, mesh, data, inputs, calls, scans)
            if rank:  # rank 0 keeps the merged leaves (the same on both)
                out[name].pop("leaves")
            cross = calls.pop("cross_network", None)  # none where only DLRM runs
            for kernel, result in update_kernels_against_plain(calls, tag=f"{tag} {name}").items():
                entry = checked.setdefault(kernel, {"max_abs_err": 0.0, "calls": []})
                entry["max_abs_err"] = max(entry["max_abs_err"], result["max_abs_err"])
                entry["calls"] += [{"run": name, **c} for c in result["calls"]]
            if cross is not None:
                x0, ws, bs = cross
                with torch.no_grad():
                    err = close(cross_network(x0, ws, bs), cross_network_plain(x0, ws, bs))
                print(f"{tag} {name} cross_network kernel vs plain x0 {list(x0.shape)}: max abs "
                      f"err {err:.3e}", flush=True)
                entry = checked.setdefault("cross_network", {"max_abs_err": 0.0, "calls": []})
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                entry["calls"].append({"run": name, "shapes": [list(x0.shape)]})
        out["against_plain"] = checked
        out["scan_witness"] = [scan_position_witness(tag, label, *call)
                               for label, call in zip(("cold shard", "hot fragment"), scans)]
        t1 = time.perf_counter()
        torch.save(out, os.path.join(tmp, f"result_{rank}.pt"))
        print(f"{tag} runs and checks {t1 - t0:.1f} s, saved in {time.perf_counter() - t1:.1f} s",
              flush=True)
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def run_ranks(target, world: int, tmp: str, deadline_s: float, tag: str) -> list:
    """``target(rank, world, tmp)`` on ``world`` spawned ranks; their results
    (``result_<rank>.pt``) in rank order. A rank that fails (its traceback in
    ``error_<rank>.txt``) or outlives the deadline ends the phase (every
    rank left is killed)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(rank, world, tmp)) for rank in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    errors = []
    for rank in range(world):
        path = os.path.join(tmp, f"error_{rank}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {rank}:\n{f.read()}")
    if errors or alive or any(p.exitcode for p in procs):
        raise AssertionError(f"{tag} ranks failed (alive {len(alive)}, exit codes "
                             f"{[p.exitcode for p in procs]}):\n" + "\n".join(errors))
    return [torch.load(os.path.join(tmp, f"result_{rank}.pt"), weights_only=False)
            for rank in range(world)]


def sharded_reference(name: str, data: dict, inputs: dict) -> dict:
    """The run's one-process twin on the card (this process), from the same
    seed and batches: the Criteo twin's packed trainer on the same flags
    with its table rows rounded to 2 alike (the plain-scan run's under
    ``plain_scan``; the grid run's twin is the 1-D run's), or the packed
    ``QuantizedEmbeddingTrainer``. Its leaves (host copies, the packed
    tables' first E columns)."""
    if name == "dlrm_int8":
        trainer = QuantizedEmbeddingTrainer(sharded_dlrm("cuda"), packed_tables=True)
        losses, _ = sharded_dlrm_run(trainer, inputs["dlrm_batches"])
    else:
        args = criteo_twin.parse_args(SHARDED_ARGV + SHARDED_RUNS[name])
        with plain_scan() if name in PLAIN_SCAN_RUNS else contextlib.nullcontext():
            out = criteo_twin.run(steps=args.steps, batch=args.batch,
                                  hash_bucket=args.hash_bucket, vocab_cap=args.vocab_cap,
                                  data=data, device="cuda", verbose=0, log=lambda message: None,
                                  table_row_multiple=2)
        trainer, losses = out["trainer"], out["step_losses"]
    leaves, packed, emb_dims = leaves_of(trainer), {}, getattr(trainer, "_emb_dims", {})
    for path in trainer.state.packed:
        if path in emb_dims:  # packed f32 rows: the table's columns (int8 rows stay whole)
            packed[path] = leaves[path]
            leaves[path] = leaves[path][:, :emb_dims[path]]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": np.asarray(losses), "leaves": leaves, "packed": packed,
            "heldout_auc": None if name == "dlrm_int8" else out["heldout_auc"]}


def lr_shares(tag: str, got: dict, want: dict) -> dict:
    """Where two Criteo runs' leaves part by more than ``SHARDED_RTOL``: the
    largest difference in shares of lr, over the tables and over the dense
    leaves (each leaf printed, a table's with its Adam ``sqrt(v_hat)``
    there)."""
    shares = {"table": 0.0, "dense": 0.0}
    for path, value in want["leaves"].items():
        mine, value = got["leaves"][path].float(), value.float()
        apart = (mine - value).abs() > SHARDED_RTOL * value.abs()
        if not bool(apart.any()):
            continue
        share = float((mine - value).abs()[apart].max()) / CRITEO_LR
        group = "table" if path in want["packed"] else "dense"
        shares[group] = max(shares[group], share)
        note = ""
        if group == "table":
            e = value.shape[1]
            v_hat = want["packed"][path][:, 2 * e:3 * e].float() / (1 - 0.999 ** SHARDED_STEPS)
            window = v_hat.sqrt()[apart]
            note = (f"; their sqrt(v_hat): median {float(window.median()):.3e}, max "
                    f"{float(window.max()):.3e}")
        print(f"{tag} {path}: {int(apart.sum())} of {value.numel()} values apart, at most "
              f"{share:.4f} lr{note}", flush=True)
    return shares


def sharded_against_reference(name: str, got: dict, want: dict) -> dict:
    """A run's losses and merged leaves against its one-process twin's:
    f32 within ``SHARDED_RTOL`` (the hot/cold run's values that part from
    it measured in shares of lr, ``lr_shares``, and held in
    ``sharded_phase``); int8 rows' q bytes at most one apart (the
    duplicate-id rule), their scale and accumulator fields within it; the
    held-out AUC within ``CRITEO_AUC_GAP``."""
    tag = f"[phase 47 {name}]"
    loss_diff = close(torch.from_numpy(got["losses"]).float(),
                      torch.from_numpy(want["losses"]).float(), rtol=SHARDED_RTOL, atol=1e-30)
    if set(got["leaves"]) != set(want["leaves"]):
        raise AssertionError(f"{tag} leaves {sorted(got['leaves'])} / {sorted(want['leaves'])}")
    worst, q_apart, shares = 0.0, 0, None
    if name == "criteo_hot_cold":
        shares = lr_shares(tag, got, want)
    else:
        for path, value in want["leaves"].items():
            mine = got["leaves"][path]
            if value.dtype == torch.uint8:  # int8 rows: q || scale || acc || staging
                e = SHARDED_DLRM["emb"]
                q_apart = max(q_apart, int((mine[:, :e].view(torch.int8).int()
                                            - value[:, :e].view(torch.int8).int()).abs().max()))
                if q_apart > 1:
                    raise AssertionError(f"{tag} {path}: q bytes {q_apart} apart")
                mine = mine[:, e:e + 8].contiguous().view(torch.float32)
                value = value[:, e:e + 8].contiguous().view(torch.float32)
            worst = max(worst, largest_difference(mine.float().contiguous(),
                                                  value.float().contiguous(), SHARDED_RTOL))
    if got["heldout_auc"] is not None and not abs(got["heldout_auc"]
                                                  - want["heldout_auc"]) <= CRITEO_AUC_GAP:
        raise AssertionError(f"{tag} held-out AUC {got['heldout_auc']}, one process "
                             f"{want['heldout_auc']}")
    return {"loss_max_abs_diff": loss_diff, "leaves_max_abs_diff": worst,
            "q_bytes_apart": q_apart, "lr_shares": shares,
            "one_process_heldout_auc": want["heldout_auc"]}


def sharded_phase(rng: np.random.Generator, seed: int, work_dir: str) -> dict:
    """Phase 47 (see the module docstring): the sharded trainer on two ranks
    sharing the card over gloo, over phase 40's shards in ``work_dir``:
    each run's launches from zero on both ranks, its losses and merged
    leaves against its one-process twin on the card, the kernels against
    their plain versions on each rank's recorded arguments, B2's witnesses
    and the hot/cold run held to them."""
    import socket

    t0 = time.perf_counter()
    card = card_line()
    previous = os.environ.get("PYTORCHREC_TPU_WORK_DIR")
    os.environ["PYTORCHREC_TPU_WORK_DIR"] = work_dir
    try:
        data = criteo_twin.formatted()
        with socket.socket() as free:  # the launcher's store: a free port here
            free.bind(("localhost", 0))
            port = free.getsockname()[1]
        inputs = {"work_dir": work_dir, "runs": list(SHARDED_RUNS),
                  "launcher": {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port)},
                  "dlrm_batches": sharded_dlrm_batches(rng)}
        with tempfile.TemporaryDirectory() as tmp:
            torch.save({**inputs, "spawned_at": time.time()}, os.path.join(tmp, "inputs.pt"))
            ranks = run_ranks(sharded_rank, SHARDED_MESH[0] * SHARDED_MESH[1], tmp,
                              SHARDED_DEADLINE_S, "[phase 47]")
        world_s = time.perf_counter() - t0
        out = {"mesh": list(SHARDED_MESH), "backend": "gloo", "world_seconds": world_s}
        references = {}
        for name in SHARDED_RUNS:
            twin = "criteo_1d" if name == "grid_f32" else name  # the grid's twin: the 1-D run's
            if twin not in references:
                t1 = time.perf_counter()
                references[twin] = sharded_reference(twin, data, inputs)
                print(f"[phase 47 {twin}] one-process twin in {time.perf_counter() - t1:.1f} s",
                      flush=True)
            checked = sharded_against_reference(name, ranks[0][name], references[twin])
            out[name] = {"launches": [r[name]["launches"] for r in ranks],
                         "host_ms_per_step": [r[name]["host_ms_per_step"] for r in ranks],
                         "rank_seconds": [r[name]["seconds"] for r in ranks],
                         "heldout_auc": ranks[0][name]["heldout_auc"], **checked}
            print(f"[phase 47 {name}] launches {out[name]['launches']} (rank 0, rank 1); "
                  f"{[round(ms, 3) for ms in out[name]['host_ms_per_step']]} ms/step (host "
                  f"clock, eager, gloo: a correctness run); losses within "
                  f"{checked['loss_max_abs_diff']:.3e}, leaves within "
                  f"{checked['leaves_max_abs_diff']:.3e} of the one-process run (lr shares "
                  f"{checked['lr_shares']}), q bytes {checked['q_bytes_apart']} apart; held-out "
                  f"AUC {out[name]['heldout_auc']} (one process "
                  f"{checked['one_process_heldout_auc']}); {card}", flush=True)
        # B2's rounding alone: one process, the kernel against the plain scan
        tag = "[phase 47 one process: B2 kernel against plain scan]"
        witness = lr_shares(tag, references["criteo_hot_cold"],
                            references[PLAIN_SCAN_RUNS[0]])
        shares = out["criteo_hot_cold"]["lr_shares"]
        out["scan_rounding_lr_shares"] = witness
        print(f"{tag} lr shares {witness}; the hot/cold run against one process {shares} "
              f"(bound {SHARDED_WITNESS_FACTOR} x the first); {card}", flush=True)
        for group, share in shares.items():
            if share > SHARDED_WITNESS_FACTOR * witness[group]:
                raise AssertionError(f"[phase 47 criteo_hot_cold] {group} values {share:.4f} lr "
                                     f"apart, {SHARDED_WITNESS_FACTOR} x B2's own rounding "
                                     f"{witness[group]:.4f} lr")
    finally:
        if previous is None:
            os.environ.pop("PYTORCHREC_TPU_WORK_DIR", None)
        else:
            os.environ["PYTORCHREC_TPU_WORK_DIR"] = previous
    out["against_plain"] = [r["against_plain"] for r in ranks]
    out["scan_witness"] = [r["scan_witness"] for r in ranks]
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 47: {len(SHARDED_RUNS)} sharded runs on two ranks of one card over gloo in "
          f"{out['seconds']:.1f} s (the world {world_s:.1f} s); {card}", flush=True)
    return out


TT_MESH = (2, 2)  # (data, model): cross-replica negatives need a data axis > 1, the
# sharded trainer a model axis > 1; four ranks share cuda:0 over gloo
TT_MESH_STEPS = 10  # eager steps of each run (batch TT_BATCH, make_tt_cpu_batch's rows)
TT_MESH_SEED = 48  # offset of the phase's generators
TT_MESH_QUERIES = 4096  # retrieval queries, 2048 a data slice
TT_MESH_B7_QUERIES = 64  # queries of B7's check against plain on a rank's shard
TT_MESH_DEADLINE_S = 600.0
# each step's loss against the one-process run: ROADMAP's f32 after N steps
TT_MESH_LOSS_RTOL = 1e-4
# tables and dense leaves after the first step, from the common starting
# state: the values outside ROADMAP's f32 rule (rtol 1e-4 / atol 1e-6)
# measured in shares of lr (phase 47's lr_shares), held to this many times
# (phase 47's factor) the larger of two one-process witnesses' partings: B2's
# kernel against its plain version (phase 47's), and the batches' rows in
# another order (the same training: the loss is a mean over the rows and
# each row's pool is every positive; every sum in another order). A value
# whose gradient's RMS sqrt(v_hat) lies under ADAM_EPS_WINDOW is counted apart
# and held within two steps (adam_values_agree's rule): there the step
# lr * m_hat / (sqrt(v_hat) + eps) turns a gradient's last bits into a share of
# lr. After the last step the partings are printed, not held: a value parted
# so carries on through the forward, and a ReLU whose input sits near 0 flips
# on a last bit, so from the second step on the runs part at random rows by
# up to a step, while one step from one state agrees
TT_MESH_PARITY = (1e-4, 1e-6)
TT_MESH_WITNESS_FACTOR = 4.0
# exact sharded retrieval against one process: scores rtol 1e-5, ids equal
# but where neighbouring scores lie within it
TT_MESH_EXACT_RTOL = 1e-5


def tt_mesh_inputs(seed: int) -> tuple:
    """Phase 48's leaves (``tt_leaves``: packed f32 tables), its training
    batches (``make_tt_cpu_batch`` at ``TT_BATCH`` rows: planted duplicate
    positives, logQ) and its queries, the same in every process."""
    leaves = tt_leaves(np.random.default_rng(seed + TT_MESH_SEED), "f32")
    rng = np.random.default_rng(seed + TT_MESH_SEED + 1)
    batches = [make_tt_cpu_batch(rng, TT_BATCH) for _ in range(TT_MESH_STEPS)]
    return leaves, batches, rng.integers(0, TT_USERS, size=TT_MESH_QUERIES)


def tt_mesh_trainer(mesh, leaves: dict, sample: dict, seed: int, axis: Optional[str]):
    """The two-tower model (accidental hits masked) under the sharded trainer
    on ``mesh`` (1-D, packed f32 tables, Adam at ``TT_LR``, the softmax),
    from ``leaves``; cross-replica negatives over ``axis`` (None: each
    rank's own rows)."""
    model = make_two_tower("f32", mesh.device, seed, mask=True, global_negatives_axis=axis)
    trainer = ShardedSparseEmbeddingTrainer(model, mesh=mesh, strategy="1d", packed_tables=True)
    trainer.compile(optimizer="adam", lr=TT_LR, loss="softmax", metrics=())
    trainer.init_state(sample, seed=seed)
    return params_from_jax(leaves, trainer)


def tt_mesh_train(tag: str, mesh, leaves: dict, batches: list, seed: int, weights: str) -> dict:
    """A rank's training half: the control step (local negatives on the
    mesh), then ``TT_MESH_STEPS`` eager steps with cross-replica negatives,
    launch counts from zero (B2 and B4 once a table a step), the update
    kernels' first calls recorded and held to their plain versions, the
    merged leaves after the first step and after the last (collectives;
    rank 0 keeps them and saves the last to ``weights``)."""
    control = tt_mesh_trainer(mesh, leaves, batches[0], seed, None)
    control_loss = float(control.train_step(batches[0]))
    del control
    gc.collect()
    torch.cuda.empty_cache()
    trainer = tt_mesh_trainer(mesh, leaves, batches[0], seed, DATA_AXIS)
    calls, losses, ms, first = {}, [], [], None
    zero_counts()
    with recording_update_kernels(calls):
        for batch in batches:
            t0 = time.perf_counter()
            losses.append(float(trainer.train_step(batch)))  # the float syncs
            ms.append(1e3 * (time.perf_counter() - t0))
            if first is None:  # a collective: every rank
                first = trainer.merged_params()
    launches = names(counts())
    check_launches(f"{tag} training", {k: 0 for k in ALL_KERNELS},
                   {segmented_sum_scan: 2 * len(batches), scatter_set_rows: 2 * len(batches)})
    if not np.isfinite(losses).all():
        raise AssertionError(f"{tag} losses {losses}")
    merged = trainer.merged_params()
    if mesh.rank == 0:
        torch.save(merged, weights)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    against = update_kernels_against_plain(calls, tag=f"{tag} kernels")
    print(f"{tag} {len(batches)} steps: losses {losses[0]:.6f} .. {losses[-1]:.6f}, control "
          f"(local negatives) {control_loss:.6f}; host-clock ms/step (eager, gloo, four ranks "
          f"on one card: a correctness figure) first {ms[0]:.1f}, median of the rest "
          f"{float(np.median(ms[1:])):.1f}; launches {launches}", flush=True)
    return {"losses": losses, "control_loss": control_loss, "launches": launches,
            "host_ms_per_step": float(np.median(ms[1:])), "first_step_ms": ms[0],
            "against_plain": against, "first": first if mesh.rank == 0 else None,
            "last": merged if mesh.rank == 0 else None}


def tt_mesh_retrieve(tag: str, mesh, queries: np.ndarray, seed: int, weights: str) -> dict:
    """A rank's serving half: the merged weights into a one-process model,
    the bf16 index built whole and sharded over the model axis, then the
    queries through ``make_sharded_retrieve_fn`` fused (B7 once a call,
    counted from zero) and exact (no kernel), twice each (host clock);
    B7 against its plain version on this rank's shard at the first fused
    call's first ``TT_MESH_B7_QUERIES`` queries."""
    mesh.barrier()  # rank 0 has saved the weights
    model = params_from_jax(torch.load(weights, weights_only=True),
                            make_two_tower("f32", mesh.device, seed))
    shard = shard_item_index(build_item_index(model, TT_ITEMS, batch_size=TT_INDEX_BATCH), mesh,
                             MODEL_AXIS)
    torch.cuda.empty_cache()
    b7_queries, kernel = [], retrieval_module.bin_max_scores

    def record(q, items, **kwargs):
        if not b7_queries:
            b7_queries.append(q[:TT_MESH_B7_QUERIES].detach().clone())
        return kernel(q, items, **kwargs)

    out = {}
    for mode, kwargs, want in (("fused", dict(approx="fused", fused_group=DEFAULT_GROUP),
                                {bin_max_scores: 1}), ("exact", dict(chunk_items=65536), {})):
        retrieve = make_sharded_retrieve_fn(model, mesh, TT_ITEMS, **kwargs)
        ms = []
        for _ in range(2):
            zero_counts()
            with swapped(retrieval_module, "bin_max_scores", record):
                t0 = time.perf_counter()
                scores, ids = retrieve(shard, queries, TT_K)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
            check_launches(f"{tag} {mode} retrieval", {k: 0 for k in ALL_KERNELS}, want)
        out[mode] = {"scores": scores.cpu(), "ids": ids.cpu(), "host_ms": ms,
                     "launches": names(counts())}
        print(f"{tag} {mode} sharded retrieval of {TT_MESH_QUERIES} queries, k={TT_K}: "
              f"host-clock ms a request (gloo, four ranks on one card: a correctness figure) "
              f"{ms[0]:.1f} then {ms[1]:.1f}", flush=True)
    q = b7_queries[0]
    with torch.no_grad():
        got, plain = bin_max_scores(q, shard), bin_max_scores_plain(q, shard)
    out["b7_max_abs_err"] = bins_agree(f"rank {mesh.rank} shard", q, shard, DEFAULT_TC,
                                       DEFAULT_GROUP, got, plain)
    out["b7_shape"] = [list(q.shape), list(shard.shape)]
    return out


def tt_mesh_rank(rank: int, world: int, tmp: str) -> None:
    """A phase-48 rank (a process of its own, spawned by ``tt_mesh_phase``
    with a launcher's environment): gloo on ``cuda:0``, the ``TT_MESH``
    mesh, ``tt_mesh_train`` then ``tt_mesh_retrieve``. Writes its results
    (``result_<rank>.pt``) or its traceback (``error_<rank>.txt``)."""
    import traceback

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                           **inputs["launcher"]})
        build("seg_scan", "scatter", "retrieval_topk")  # the parent's libraries
        tag = f"[phase 48 rank {rank}]"
        print(f"{tag} up {time.time() - inputs['spawned_at']:.1f} s after the spawn", flush=True)
        t0 = time.perf_counter()
        initialize_distributed(device="cuda:0", backend="gloo", init_method="env://",
                               world_size=world, rank=rank,
                               timeout=datetime.timedelta(seconds=TT_MESH_DEADLINE_S))
        mesh = make_mesh(*TT_MESH, device="cuda:0")
        leaves, batches, queries = tt_mesh_inputs(inputs["seed"])
        weights = os.path.join(tmp, "weights.pt")
        out = {"train": tt_mesh_train(tag, mesh, leaves, batches, inputs["seed"], weights)}
        del leaves
        t1 = time.perf_counter()
        out["retrieve"] = tt_mesh_retrieve(tag, mesh, queries, inputs["seed"], weights)
        out["seconds"] = {"train": t1 - t0, "retrieve": time.perf_counter() - t1}
        torch.save(out, os.path.join(tmp, f"result_{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def tt_one_process(leaves: dict, batches: list, seed: int, reorder: bool = False) -> dict:
    """The one-process twin on the card: ``SparseEmbeddingTrainer`` (packed
    f32), local negatives over the whole batch, from the same leaves and
    batches (with ``reorder``, each batch's rows in another order: the same
    training, every sum in another order); its losses and leaves (the
    tables' first E columns) after the first step and after the last, and
    the first step's ``v_hat`` by leaf."""
    if reorder:
        order = np.random.default_rng(seed + TT_MESH_SEED + 2).permutation(TT_BATCH)
        batches = [{k: v[order] for k, v in batch.items()} for batch in batches]
    trainer = SparseEmbeddingTrainer(make_two_tower("f32", "cuda", seed, mask=True),
                                     device="cuda", packed_tables=True)
    trainer.compile(optimizer="adam", lr=TT_LR, loss="softmax", metrics=())
    trainer.init_state(batches[0], seed=seed)
    params_from_jax(leaves, trainer)
    losses, out = [], {}
    for step, batch in enumerate(batches):
        losses.append(float(trainer.train_step(batch)))
        if step == 0:
            out["first"], out["first_v_hat"] = tt_leaves_of(trainer, v_hat=True)
    out["last"], _ = tt_leaves_of(trainer)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": np.asarray(losses), **out}


def tt_leaves_of(trainer, v_hat: bool = False) -> tuple:
    """A one-process trainer's leaves by flax path (the packed tables' first E
    columns), and with ``v_hat`` each value's bias-corrected Adam second
    moment (the packed rows' v; the dense optimizer's ``exp_avg_sq``, kernels
    in the flax layout)."""
    leaves, moments = leaves_of(trainer), {}
    correction = 1 - ADAM_BETA2 ** trainer.state.step
    for path in trainer.state.packed:  # table || m || v || staging
        if v_hat:
            moments[path] = leaves[path][:, 2 * TT_EMB:3 * TT_EMB] / correction
        leaves[path] = leaves[path][:, :TT_EMB]
    if v_hat:
        paths = {id(p): flax_path(name) for name, p in trainer.model.named_parameters()}
        for p, state in trainer.state.optimizer.state.items():
            v = state["exp_avg_sq"].detach().cpu() / correction
            moments[paths[id(p)]] = v.t() if v.dim() == 2 else v
    return leaves, moments


def lr_parting(got: dict, want: dict, v_hat: Optional[dict] = None) -> dict:
    """The largest difference, in shares of lr, over the values of two runs'
    leaves outside ROADMAP's f32 rule (``TT_MESH_PARITY``), in the tables
    and in the dense leaves (0 where none is), and how many values that is;
    with ``v_hat``, the values in Adam's eps window apart (see
    ``TT_MESH_PARITY``), counted with their largest difference."""
    rtol, atol = TT_MESH_PARITY
    if set(got) != set(want) or (v_hat is not None and set(v_hat) != set(want)):
        raise AssertionError(f"leaves {sorted(got)} against {sorted(want)}")
    shares = {"table": 0.0, "dense": 0.0, "values_apart": 0}
    if v_hat is not None:
        shares.update(window_values_apart=0, window_lr=0.0)
    for path, value in want.items():
        diff = (got[path].float() - value.float()).abs()
        apart = diff > atol + rtol * value.float().abs()
        if v_hat is not None:
            window = v_hat[path].sqrt() < ADAM_EPS_WINDOW
            if bool((apart & window).any()):
                shares["window_values_apart"] += int((apart & window).sum())
                shares["window_lr"] = max(shares["window_lr"],
                                          float(diff[apart & window].max()) / TT_LR)
            apart &= ~window
        if bool(apart.any()):
            group = "table" if path.endswith("embeddings/embedding") else "dense"
            shares[group] = max(shares[group], float(diff[apart].max()) / TT_LR)
            shares["values_apart"] += int(apart.sum())
    return shares


def exact_ids_agree(label: str, got, want) -> int:
    """Sharded exact retrieval against one process's: scores within
    ``TT_MESH_EXACT_RTOL`` position by position; ids equal but where the
    score lies within that tolerance of a neighbouring position's (or at
    the k-th, where an equal score past k may take the place). Returns the
    count of such places."""
    (gs, gi), (ws, wi) = ((s.float().cpu(), i.cpu()) for s, i in (got, want))
    close(gs, ws, rtol=TT_MESH_EXACT_RTOL, atol=1e-30)
    differ = gi != wi
    tol = TT_MESH_EXACT_RTOL * ws.abs()
    near = torch.zeros_like(differ)
    near[:, 1:] |= (ws[:, 1:] - ws[:, :-1]).abs() <= tol[:, 1:]
    near[:, :-1] |= (ws[:, :-1] - ws[:, 1:]).abs() <= tol[:, :-1]
    near[:, -1] = True
    if bool((differ & ~near).any()):
        raise AssertionError(f"{label}: {int((differ & ~near).sum())} ids differ away from a tie")
    return int(differ.sum())


def tt_mesh_phase(seed: int) -> dict:
    """Phase 48 (see the module docstring): two-tower training with
    cross-replica negatives and corpus-sharded retrieval on four ranks
    sharing the card over gloo, held to one process on the card."""
    import socket

    t0 = time.perf_counter()
    card = card_line()
    with socket.socket() as free:  # the launcher's store: a free port here
        free.bind(("localhost", 0))
        port = free.getsockname()[1]
    inputs = {"seed": seed, "launcher": {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({**inputs, "spawned_at": time.time()}, os.path.join(tmp, "inputs.pt"))
        ranks = run_ranks(tt_mesh_rank, TT_MESH[0] * TT_MESH[1], tmp, TT_MESH_DEADLINE_S,
                          "[phase 48]")
        merged = torch.load(os.path.join(tmp, "weights.pt"), weights_only=True)
    world_s = time.perf_counter() - t0
    leaves, batches, queries = tt_mesh_inputs(seed)
    t1 = time.perf_counter()
    one = tt_one_process(leaves, batches, seed)
    with plain_scan():
        plain_run = tt_one_process(leaves, batches, seed)
    reordered_run = tt_one_process(leaves, batches, seed, reorder=True)
    del leaves
    reference_s = time.perf_counter() - t1
    tag = "[phase 48]"

    # training: every rank's losses equal (the data group's mean), each step
    # within TT_MESH_LOSS_RTOL of one process's; the leaves after the first
    # step within TT_MESH_WITNESS_FACTOR times the witnesses' parting (see
    # TT_MESH_PARITY), after the last printed; the control step parts
    train = [r["train"] for r in ranks]
    for r, t in enumerate(train[1:], 1):
        if t["losses"] != train[0]["losses"]:
            raise AssertionError(f"{tag} rank {r} losses {t['losses']}, rank 0 {train[0]['losses']}")
    losses = torch.tensor(train[0]["losses"], dtype=torch.float64)
    loss_diff = close(losses, torch.from_numpy(one["losses"]).double(), rtol=TT_MESH_LOSS_RTOL,
                      atol=1e-30)
    first = {"sharded": lr_parting(train[0]["first"], one["first"], one["first_v_hat"]),
             "b2_plain": lr_parting(plain_run["first"], one["first"], one["first_v_hat"]),
             "rows_reordered": lr_parting(reordered_run["first"], one["first"],
                                          one["first_v_hat"])}
    last = {"sharded": lr_parting(train[0]["last"], one["last"]),
            "b2_plain": lr_parting(plain_run["last"], one["last"]),
            "rows_reordered": lr_parting(reordered_run["last"], one["last"])}
    bound = {group: TT_MESH_WITNESS_FACTOR * max(first[w][group] for w in ("b2_plain",
                                                                         "rows_reordered"))
             for group in ("table", "dense")}
    reordered_loss_diff = close(torch.from_numpy(reordered_run["losses"]).double(),
                                torch.from_numpy(one["losses"]).double(),
                                rtol=TT_MESH_LOSS_RTOL, atol=1e-30)
    print(f"{tag} training against one process: losses within {loss_diff:.3e} (rtol "
          f"{TT_MESH_LOSS_RTOL}; the reordered rows' {reordered_loss_diff:.3e}); values outside "
          f"rtol {TT_MESH_PARITY[0]} / atol {TT_MESH_PARITY[1]}, in lr, after the first step: "
          f"{first}, bound {bound}; after step {TT_MESH_STEPS} (not held): {last}; {card}",
          flush=True)
    for group, limit in bound.items():
        if first["sharded"][group] > limit:
            raise AssertionError(f"{tag} {group} values {first['sharded'][group]:.4g} lr apart "
                                 f"from one process after the first step, the bound "
                                 f"{limit:.4g} lr")
    for name, shares in first.items():
        if shares["window_lr"] > 2.01:
            raise AssertionError(f"{tag} {name}: a value in Adam's eps window "
                                 f"{shares['window_lr']:.4g} lr apart after the first step")
    control_gap = abs(train[0]["control_loss"] - float(one["losses"][0]))
    if not control_gap > TT_MESH_LOSS_RTOL * abs(float(one["losses"][0])):
        raise AssertionError(f"{tag} the control step (local negatives) {train[0]['control_loss']} "
                             f"does not part from one process's {one['losses'][0]}")
    print(f"{tag} control step with local negatives on the mesh: loss "
          f"{train[0]['control_loss']:.6f} against one process's {float(one['losses'][0]):.6f} "
          f"(apart {control_gap:.4f}: the gather is active)", flush=True)

    # retrieval: each rank's exact result against one process's exact path
    # over the same weights and index; its fused result's recall and exact
    # scores
    model = params_from_jax(merged, make_two_tower("f32", "cuda", seed))
    index = build_item_index(model, TT_ITEMS, batch_size=TT_INDEX_BATCH)
    exact = make_retrieve_fn(model, chunk_items=65536).eager(index, queries, TT_K)
    retrieval = []
    for r, result in enumerate(ranks):
        got = result["retrieve"]
        ties = exact_ids_agree(f"{tag} rank {r} exact", (got["exact"]["scores"],
                                                         got["exact"]["ids"]), exact)
        fused_ids = got["fused"]["ids"]
        recall = recall_at_k(fused_ids, exact[1].cpu())
        if not recall >= TT_RECALL_MIN:
            raise AssertionError(f"{tag} rank {r} fused recall@{TT_K} {recall}")
        err = scores_exact(f"{tag} rank {r} fused", model, index, queries,
                           got["fused"]["scores"].cuda(), fused_ids.cuda())
        retrieval.append({"exact_ids_at_ties": ties, "fused_recall": recall,
                          "fused_score_max_abs_err": err,
                          "fused_host_ms": got["fused"]["host_ms"],
                          "exact_host_ms": got["exact"]["host_ms"],
                          "b7_max_abs_err": got["b7_max_abs_err"], "b7_shape": got["b7_shape"]})
        print(f"{tag} rank {r}: exact ids equal to one process's but {ties} at ties; fused "
              f"recall@{TT_K} {recall:.5f}", flush=True)
    del model, index
    gc.collect()
    torch.cuda.empty_cache()
    out = {"mesh": list(TT_MESH), "backend": "gloo", "steps": TT_MESH_STEPS, "batch": TT_BATCH,
           "losses": train[0]["losses"], "one_process_losses": one["losses"].tolist(),
           "loss_max_abs_diff": loss_diff, "first_step_lr_shares": first,
           "lr_share_bound": bound, "last_step_lr_shares": last,
           "control_loss": train[0]["control_loss"],
           "launches": [t["launches"] for t in train],
           "host_ms_per_step": [t["host_ms_per_step"] for t in train],
           "retrieval": retrieval,
           "fused_launches": [r["retrieve"]["fused"]["launches"] for r in ranks],
           "against_plain": [t["against_plain"] for t in train],
           "rank_seconds": [r["seconds"] for r in ranks], "world_seconds": world_s,
           "reference_seconds": reference_s}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 48: two-tower on a {TT_MESH} mesh, four ranks on one card over gloo, in "
          f"{out['seconds']:.1f} s (the world {world_s:.1f} s, the one-process runs "
          f"{reference_s:.1f} s); {card}", flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 throughout, as the reference
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)

    # 1. card
    print(card_line())
    kind = torch.cuda.get_device_name(0)
    print(f"torch device 0: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build (the ops library and the server of phase 43 beside the kernels)
    serving_builds = concurrent.futures.ThreadPoolExecutor(1).submit(build_serving)
    t0 = time.perf_counter()
    paths = build("cross", "seg_scan", "scatter", "requantize", "fm", "din_attention",
                  "retrieval_topk", "quantize")
    print(f"built {', '.join(str(p.name) for p in paths.values())} in {time.perf_counter() - t0:.1f} s")

    # 3. kernel against plain, then against cuBLAS over a grid (these
    # launches are not the main path's)
    max_err = check_cross(rng)
    against_cublas = check_against_cublas()

    # 4. serving: the serving path, with launch counts from zero
    requests = make_requests(rng)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    served = sum(serve_table(DCNV2_SPEC, table, requests, args.seed) for table in ("f32", "int8"))
    check_launches("DCN-v2 serving", {k: 0 for k in ALL_KERNELS}, {cross_network: served})
    serving_launches = cross_network.launches
    print(f"serving: {served} requests, cross_network launches {serving_launches}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # 5. cross timings at the request sizes, at D=429 and at E=64's D=1677;
    # the training batch at D=429 heads the kernels line
    cross_times = {f"D={dim}": {str(batch): time_cross(rng, batch, dim) for batch in REQUEST_ROWS}
                   for dim in (DIM, E64_DIM)}
    cross_timing = {k: v for k, v in cross_times[f"D={DIM}"][str(TRAIN_BATCH)].items()
                    if k != "form"}

    # 6. training kernels against plain, and their times at the f32 and the
    # int8 step's shapes (not the main path's launches)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    scan_err, scan_x, scan_heads = check_seg_scan(rng, gen)
    scan_timing = time_seg_scan(scan_x, scan_heads)
    scan_x, scan_heads = scan_input(unified_ids(make_train_batch(rng)), gen, "int8")
    err = close(segmented_sum_scan(scan_x, scan_heads),
                segmented_sum_scan_plain(scan_x, scan_heads), rtol=1e-5, atol=1e-5)
    print(f"segmented_sum_scan kernel vs plain  bench ids, int8 rows (row stride "
          f"{scan_x.stride(0)}): max abs err {err:.3e}")
    scan_edges("bench ids, int8 rows", scan_x, scan_heads)
    scan_timing_int8 = time_seg_scan(scan_x, scan_heads)
    del scan_x, scan_heads
    scatter_err, scatter_timing = check_and_time_scatter(rng, gen, "f32")
    _, scatter_timing_int8 = check_and_time_scatter(rng, gen, "int8")
    grad_err = check_cross_grad(rng, gen)
    torch.cuda.empty_cache()

    # 44. B4 at every plan and main-path width (generators of its own)
    b4 = b4_sweep(args.seed)

    # 7. f32 training, with launch counts from zero
    leaves = flax_leaves(np.random.default_rng(args.seed + 3), "f32")
    f32_launches, f32_ms, _ = train(DCNV2_SPEC, "f32", leaves, rng, args.seed)
    torch.cuda.empty_cache()

    # 8. f32 card against CPU
    card_against_cpu(DCNV2_SPEC, "f32", leaves, rng, args.seed)
    del leaves

    # 9. the requantize kernel against plain at the int8 step's shape and
    # DIN's, and its times at both (not the main path's launches)
    requant_err, requant_timing, requant_din_timing = check_and_time_requantize(
        rng, gen, args.seed)
    torch.cuda.empty_cache()

    # 10. int8 training, with launch counts from zero
    leaves = flax_leaves(np.random.default_rng(args.seed + 4), "int8")
    launches, int8_ms, _ = train(DCNV2_SPEC, "int8", leaves, rng, args.seed)
    print(f"[train] int8-packed {int8_ms:.3f} ms/step against f32-packed {f32_ms:.3f} ms/step "
          f"({f32_ms / int8_ms:.3f}x)")
    torch.cuda.empty_cache()

    # 11. int8 card against CPU
    card_against_cpu(DCNV2_SPEC, "int8", leaves, rng, args.seed)
    del leaves

    # 12. the FM kernels against plain, and B2 at the linear table's E=1
    # (not the main path's launches)
    fm_errs, fm_timing = check_and_time_fm(gen)
    scan_timing_lin = check_and_time_lin_scan(rng, gen)
    torch.cuda.empty_cache()

    # 13. DeepFM serving, with launch counts from zero
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    deepfm_served = sum(serve_table(DEEPFM_SPEC, table, requests, args.seed,
                                    profiled=PROFILED_SHAPES[1:])
                        for table in ("f32", "int8"))
    check_launches("DeepFM serving", {k: 0 for k in ALL_KERNELS}, {fm_interaction: deepfm_served})
    deepfm_serving_launches = fm_interaction.launches
    print(f"DeepFM serving: {deepfm_served} requests, fm_interaction launches "
          f"{deepfm_serving_launches}, fm_interaction_backward launches "
          f"{fm_interaction_backward.launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    torch.cuda.empty_cache()

    # 14. DeepFM f32 training, with launch counts from zero
    leaves = deepfm_leaves(np.random.default_rng(args.seed + 5), "f32")
    fm_f32_launches, fm_f32_ms, shares = train(DEEPFM_SPEC, "f32", leaves, rng, args.seed,
                                               table_shares=True)
    torch.cuda.empty_cache()

    # 16 (f32). DeepFM f32 card against CPU
    card_against_cpu(DEEPFM_SPEC, "f32", leaves, rng, args.seed)
    del leaves

    # 15. DeepFM int8 training, with launch counts from zero
    leaves = deepfm_leaves(np.random.default_rng(args.seed + 6), "int8")
    fm_int8_launches, fm_int8_ms, _ = train(DEEPFM_SPEC, "int8", leaves, rng, args.seed)
    print(f"[train deepfm] int8-packed {fm_int8_ms:.3f} ms/step, f32-packed {fm_f32_ms:.3f} "
          f"ms/step; DCN-v2 int8 {int8_ms:.3f}, f32 {f32_ms:.3f} ms/step in this run")
    torch.cuda.empty_cache()

    # 16 (int8). DeepFM int8 card against CPU
    card_against_cpu(DEEPFM_SPEC, "int8", leaves, rng, args.seed)
    del leaves
    torch.cuda.empty_cache()

    # 17. the DIN pooling kernel against plain, and the update's kernels at
    # DIN's step shape (not the main path's launches)
    din_err, din_grad_err, din_timing = check_and_time_din(gen)
    din_update_timing = check_and_time_din_update(rng, gen)
    torch.cuda.empty_cache()

    # 18. DIN serving, with launch counts from zero
    din_requests = make_din_requests(rng)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    din_served = sum(serve_table(DIN_SPEC, table, din_requests, args.seed,
                                 profiled=(din_requests[-1][2],))
                     for table in ("f32", "int8"))
    check_launches("DIN serving", {k: 0 for k in ALL_KERNELS}, {din_attention_pool: din_served})
    din_serving_launches = din_attention_pool.launches
    print(f"DIN serving: {din_served} requests, din_attention_pool launches "
          f"{din_serving_launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    torch.cuda.empty_cache()

    # 19. DIN f32 training, with launch counts from zero
    leaves = din_leaves(np.random.default_rng(args.seed + 7), "f32")
    din_f32_launches, din_f32_ms, _ = train(DIN_SPEC, "f32", leaves, rng, args.seed)
    torch.cuda.empty_cache()

    # 21 (f32). DIN f32 card against CPU
    stepped_card_against_cpu(DIN_SPEC, "f32", leaves, rng, args.seed)
    del leaves
    torch.cuda.empty_cache()

    # 20. DIN int8 training, with launch counts from zero
    leaves = din_leaves(np.random.default_rng(args.seed + 8), "int8")
    din_int8_launches, din_int8_ms, _ = train(DIN_SPEC, "int8", leaves, rng, args.seed)
    print(f"[train din] int8-packed {din_int8_ms:.3f} ms/step, f32-packed {din_f32_ms:.3f} "
          f"ms/step at batch {DIN_BATCH}")
    torch.cuda.empty_cache()

    # 21 (int8). DIN int8 card against CPU
    stepped_card_against_cpu(DIN_SPEC, "int8", leaves, rng, args.seed)
    del leaves
    torch.cuda.empty_cache()

    # 22. B7 against plain, and its times at the serving shape (not the main
    # path's launches)
    b7_err, b7_timing = check_and_time_b7(gen)
    torch.cuda.empty_cache()

    # 23. two-tower retrieval serving, with launch counts from zero
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    tt_serving = serve_two_tower(args.seed)
    check_launches("two-tower serving", {k: 0 for k in ALL_KERNELS},
                   {bin_max_scores: tt_serving["fused_calls"]})
    tt_serving_launches = bin_max_scores.launches
    print(f"two-tower serving: bin_max_scores launches {tt_serving_launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    torch.cuda.empty_cache()

    # 24. two-tower f32 training, with launch counts from zero
    leaves = tt_leaves(np.random.default_rng(args.seed + 10), "f32")
    tt_f32_launches, tt_f32_ms, _ = train(TT_SPEC, "f32", leaves, rng, args.seed)
    torch.cuda.empty_cache()

    # 26 (f32). two-tower f32 card against CPU
    stepped_card_against_cpu(TT_CPU_SPEC, "f32", leaves, rng, args.seed)
    del leaves
    torch.cuda.empty_cache()

    # 25. two-tower int8 training, with launch counts from zero
    leaves = tt_leaves(np.random.default_rng(args.seed + 11), "int8")
    tt_int8_launches, tt_int8_ms, _ = train(TT_SPEC, "int8", leaves, rng, args.seed)
    print(f"[train two_tower] int8-packed {tt_int8_ms:.3f} ms/step, f32-packed {tt_f32_ms:.3f} "
          f"ms/step at batch {TT_BATCH}")
    torch.cuda.empty_cache()

    # 26 (int8). two-tower int8 card against CPU
    stepped_card_against_cpu(TT_CPU_SPEC, "int8", leaves, rng, args.seed)
    del leaves
    torch.cuda.empty_cache()

    # 27. B8 against plain, its time, and the classic update's parts (not the
    # main path's launches)
    b8_err, b8_timing, classic_parts = check_and_time_b8(rng, gen, args.seed)
    torch.cuda.empty_cache()

    # 28. classic int8 serving, DCN-v2 and DeepFM, with launch counts from zero
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    classic_served = {spec.name: serve_table(spec, "classic", requests, args.seed,
                                             profiled=PROFILED_SHAPES[1:])
                      for spec in (DCNV2_SPEC, DEEPFM_SPEC)}
    check_launches("classic serving", {k: 0 for k in ALL_KERNELS},
                   {cross_network: classic_served["dcnv2"],
                    fm_interaction: classic_served["deepfm"]})
    print(f"classic serving: {classic_served} requests, stochastic_quantize_rows launches "
          f"{stochastic_quantize_rows.launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    torch.cuda.empty_cache()

    # 29 and 31. classic int8 DCN-v2 training, with launch counts from zero,
    # and the card against the CPU
    leaves = flax_leaves(np.random.default_rng(args.seed + 12), "classic")
    with counting_hash() as hashes:
        classic_launches, classic_ms, _ = train(DCNV2_SPEC, "classic", leaves, rng, args.seed)
    check_no_torch_hash("dcnv2 classic", hashes[0])
    torch.cuda.empty_cache()
    card_against_cpu(DCNV2_SPEC, "classic", leaves, rng, args.seed)
    del leaves
    torch.cuda.empty_cache()

    # 30 and 31. classic int8 DeepFM training, with launch counts from zero,
    # and the card against the CPU
    leaves = deepfm_leaves(np.random.default_rng(args.seed + 13), "classic")
    with counting_hash() as hashes:
        fm_classic_launches, fm_classic_ms, _ = train(DEEPFM_SPEC, "classic", leaves, rng,
                                                      args.seed)
    check_no_torch_hash("deepfm classic", hashes[0])
    torch.cuda.empty_cache()
    card_against_cpu(DEEPFM_SPEC, "classic", leaves, rng, args.seed)
    del leaves
    torch.cuda.empty_cache()

    # 32. the classic step against the packed step on unique ids
    classic_vs_packed = classic_against_packed(np.random.default_rng(args.seed + 14), args.seed)
    torch.cuda.empty_cache()

    # 33. classic int4 and two scale groups: no B8
    other_ms = {}
    for offset, table in enumerate(("classic_int4", "classic_g2")):
        leaves = flax_leaves(np.random.default_rng(args.seed + 15 + offset), table)
        with counting_hash() as hashes:
            _, other_ms[table], _ = train(DCNV2_SPEC, table, leaves, rng, args.seed)
        if not hashes[0]:
            raise AssertionError(f"[train dcnv2 {table}] the torch id-keyed hash never ran")
        print(f"[train dcnv2 {table}] the torch id-keyed hash ran {hashes[0]} times (no B8)")
        del leaves
        torch.cuda.empty_cache()
    print(f"[train dcnv2] classic int8 {classic_ms:.3f} ms/step, int4 "
          f"{other_ms['classic_int4']:.3f}, two scale groups {other_ms['classic_g2']:.3f}; "
          f"packed int8 {int8_ms:.3f}, f32 {f32_ms:.3f} ms/step in this run")

    # 34. DCN-v2 at E=64 (D=1677: B1's tiled form), serving and training,
    # with launch counts from zero
    e64_requests = make_requests(rng, E64_REQUEST_ROWS, candidates=False)
    zero_counts()
    e64_served = sum(serve_table(E64_SPEC, table, e64_requests, args.seed,
                                 profiled=PROFILED_SHAPES[1:])
                     for table in ("f32", "int8"))
    check_launches("DCN-v2 E=64 serving", {k: 0 for k in ALL_KERNELS}, {cross_network: e64_served})
    e64_serving_launches = cross_network.launches
    torch.cuda.empty_cache()
    e64_train = {}
    for offset, table in enumerate(("f32", "int8")):
        leaves = flax_leaves(np.random.default_rng(args.seed + 17 + offset), table, E64)
        launches_e64, e64_train[table], _ = train(E64_SPEC, table, leaves, rng, args.seed)
        e64_train[f"{table}_launches"] = launches_e64["cross_network"]
        del leaves
        torch.cuda.empty_cache()
    print(f"[dcnv2 E=64, D={E64_DIM}] serving: {e64_served} requests, cross_network launches "
          f"{e64_serving_launches}; training f32 {e64_train['f32']:.3f}, int8 "
          f"{e64_train['int8']:.3f} ms/step at batch {TRAIN_BATCH}")

    # 35. captured steps against eager ones, with launch counts from zero
    capture = capture_phase(rng, args.seed)

    # 36. captured requests against eager ones, and evaluation, with launch
    # counts from zero
    requests_capture = request_capture_phase(requests, din_requests, args.seed)

    # 37. the fit loop on the captured step, callbacks, resume and loads in
    # place, with launch counts from zero
    fit = fit_phase(capture, args.seed)

    # 38. the factorization and sequence zoo: captured steps against eager
    # ones, serving, SASRec's evaluation and the card against the CPU, each
    # path's launches from zero
    zoo = zoo_phase(rng, args.seed)

    # 39. the dataset path: files through the processing pipeline and a
    # reader to fit and evaluate, DIN and DCN-v2, each run's launches from zero
    files = files_phase(args.seed)

    # 40. the streaming Criteo path: the example's twin, raw TSV to held-out
    # AUC, bf16, f32 and two vocab runs, each run's launches from zero
    criteo_dir = tempfile.TemporaryDirectory()  # phase 40's shards, which phase 47 reads
    criteo = criteo_phase(args.seed, criteo_dir.name)

    # 41. DLRM and the table formats: serving, captured training, the format
    # contenders, card against CPU, each run's launches from zero
    dlrm = dlrm_phase(rng, args.seed)

    # 42. the normal entry point: console_main, Task.from_config (the
    # multi-task family), the new optimizers, the harnesses and the
    # profiler, each run's launches from zero
    tasks = tasks_phase(rng, args.seed)

    # 43. the serving export: four bundles scored by the Python-free server,
    # load_serving and the captured scorer beside it, each path's launches
    # from zero
    bundles = serving_bundle_phase(rng, args.seed, serving_builds)

    # 45. value-based RL: DQN at full width under the four trainers, the
    # kernels against plain on RL's arguments, the sync cadence in captured
    # windows, card against CPU and the entry point, each run's launches
    # from zero
    rl = rl_phase(rng, args.seed)

    # 46. the mesh: a world of one over NCCL, each training path on the mesh
    # and without it, captured, launches from zero, the kernels against plain
    mesh46 = mesh_phase(rng, args.seed)

    # 47. the sharded trainer: two ranks sharing the card over gloo, the
    # Criteo twin's --mesh 1,2 and --hot_mass over phase 40's shards, the
    # grid and DLRM's int8 rows, each run's launches from zero on each rank,
    # against its one-process twin, the kernels against plain on each rank
    sharded = sharded_phase(rng, args.seed, criteo_dir.name)
    criteo_dir.cleanup()

    # 48. two-tower on a (2, 2) mesh: four ranks sharing the card over gloo,
    # cross-replica negatives under the sharded trainer (B2, B4) against one
    # process, corpus-sharded retrieval (B7 on each shard) against one
    # process's exact path, the kernels against plain on each rank
    tt_mesh = tt_mesh_phase(args.seed)

    n_scan = TRAIN_BATCH * N_SPARSE
    vocab_rows = N_SPARSE * VOCAB
    fm_shape = f"[{TRAIN_BATCH}, {FM_FIELDS}, {EMB}] f32"

    def deepfm_launches(name):
        return {"deepfm_f32_train_launches": fm_f32_launches[name],
                "deepfm_int8_train_launches": fm_int8_launches[name]}

    def din_launches(name):
        return {"din_f32_train_launches": din_f32_launches[name],
                "din_int8_train_launches": din_int8_launches[name]}

    n_din = DIN_BATCH * (DIN_CAND + DIN_STEPS)

    entries = [
        {"name": "cross_network", "route": "cuda",
         "source": "pytorchrec_tpu_torch/csrc/cross.cu",
         "replaces": "pytorchrec_tpu/ops/kernels/cross.py:50",
         "launches": launches["cross_network"], "max_abs_err": max_err, **cross_timing,
         "shape": f"B={TRAIN_BATCH} D={DIM} L={CROSS_LAYERS} f32",
         "f32_train_launches": f32_launches["cross_network"],
         "serving_launches": serving_launches, "grad_max_abs_err": grad_err,
         "max_width": None, "times": cross_times, "against_cublas": against_cublas,
         "e64": {"shape": f"D={E64_DIM} L={CROSS_LAYERS} f32",
                 "serving_launches": e64_serving_launches,
                 "f32_train_launches": e64_train["f32_launches"],
                 "int8_train_launches": e64_train["int8_launches"],
                 "f32_ms_per_step": e64_train["f32"], "int8_ms_per_step": e64_train["int8"]}},
        {"name": "segmented_sum_scan", "route": "cuda",
         "source": "pytorchrec_tpu_torch/csrc/seg_scan.cu",
         "replaces": "pytorchrec_tpu/ops/kernels/seg_scan.py:108",
         "launches": launches["segmented_sum_scan"], "max_abs_err": scan_err, **scan_timing,
         "shape": f"n={n_scan} E={EMB} f32, row stride {PACKED_W}",
         "f32_train_launches": f32_launches["segmented_sum_scan"],
         "classic_train_launches": classic_launches["segmented_sum_scan"],
         **deepfm_launches("segmented_sum_scan"), **din_launches("segmented_sum_scan"),
         "int8": {"shape": f"n={n_scan} E={EMB} f32, row stride {Q_W // 4}",
                  **scan_timing_int8},
         "linear_table": {"shape": f"n={n_scan} E=1 f32, row stride {PACKED_W}",
                          **scan_timing_lin},
         "din_f32": {"shape": f"n={n_din} E={DIN_EMB} f32, row stride {DIN_PACKED_W}",
                     **din_update_timing["scan_f32"]},
         "din_int8": {"shape": f"n={n_din} E={DIN_EMB} f32, row stride {DIN_Q_W // 4}",
                      **din_update_timing["scan_int8"]}},
        {"name": "requantize_rows", "route": "cuda",
         "source": "pytorchrec_tpu_torch/csrc/requantize.cu",
         "replaces": "pytorchrec_tpu/ops/kernels/quantize.py:243",
         "launches": launches["requantize_rows"], "max_abs_err": requant_err, **requant_timing,
         "shape": f"n={n_scan} rows of {Q_W} u8, E={EMB}",
         "deepfm_int8_train_launches": fm_int8_launches["requantize_rows"],
         "din_int8_train_launches": din_int8_launches["requantize_rows"],
         "din": {"shape": f"n={n_din} rows of {DIN_Q_W} u8, E={DIN_EMB}",
                 **requant_din_timing}},
        {"name": "scatter_set_rows", "route": "cuda",
         "source": "pytorchrec_tpu_torch/csrc/scatter.cu",
         "replaces": "pytorchrec_tpu/ops/kernels/dma_scatter.py:117",
         "launches": launches["scatter_set_rows"], "max_abs_err": scatter_err, **scatter_timing,
         "shape": f"n={n_scan} rows of {PACKED_W} f32 into [{vocab_rows}, {PACKED_W}]",
         "f32_train_launches": f32_launches["scatter_set_rows"],
         "classic_train_launches": classic_launches["scatter_set_rows"],
         **deepfm_launches("scatter_set_rows"), **din_launches("scatter_set_rows"),
         "int8": {"shape": f"n={n_scan} rows of {Q_W} u8 into [{vocab_rows}, {Q_W}]",
                  **scatter_timing_int8},
         "din_f32": {"shape": f"n={n_din} rows of {DIN_PACKED_W} f32 into "
                              f"[{DIN_ITEMS}, {DIN_PACKED_W}]",
                     **din_update_timing["scatter_f32"]},
         "din_int8": {"shape": f"n={n_din} rows of {DIN_Q_W} u8 into [{DIN_ITEMS}, {DIN_Q_W}]",
                      **din_update_timing["scatter_int8"]},
         "sweep": b4},
        {"name": "fm_interaction", "route": "cuda",
         "source": "pytorchrec_tpu_torch/csrc/fm.cu",
         "replaces": "pytorchrec_tpu/ops/kernels/fm.py:24",
         "launches": fm_f32_launches["fm_interaction"], "max_abs_err": fm_errs["fwd"],
         **fm_timing["fwd"], "shape": fm_shape,
         "deepfm_int8_train_launches": fm_int8_launches["fm_interaction"],
         "serving_launches": deepfm_serving_launches, "grad_max_abs_err": fm_errs["grad"],
         "library_note": "no single PyTorch call computes the FM interaction"},
        {"name": "fm_interaction_backward", "route": "cuda",
         "source": "pytorchrec_tpu_torch/csrc/fm.cu",
         "replaces": "pytorchrec_tpu/ops/kernels/fm.py:31",
         "launches": fm_f32_launches["fm_interaction_backward"], "max_abs_err": fm_errs["bwd"],
         **fm_timing["bwd"], "shape": f"{fm_shape}, g [{TRAIN_BATCH}]",
         "deepfm_int8_train_launches": fm_int8_launches["fm_interaction_backward"],
         "library_note": "no single PyTorch call computes g * (sum_f v - v)"},
        {"name": "din_attention_pool", "route": "cuda",
         "source": "pytorchrec_tpu_torch/csrc/din_attention.cu",
         "replaces": "pytorchrec_tpu/ops/kernels/din_attention.py:144",
         "launches": din_f32_launches["din_attention_pool"], "max_abs_err": din_err,
         **din_timing["train"],
         "shape": f"[{DIN_BATCH}, {DIN_CAND}, {DIN_STEPS}, {DIN_EMB}] f32, score MLP {DIN_ATT}",
         "din_int8_train_launches": din_int8_launches["din_attention_pool"],
         "serving_launches": din_serving_launches, "grad_max_abs_err": din_grad_err,
         "serving": {"shape": f"[1024, {DIN_LOO}, {DIN_STEPS}, {DIN_EMB}] f32",
                     **din_timing["serve"]},
         "library_note": "no single PyTorch call computes MLP-scored attention pooling "
                         "(scaled_dot_product_attention scores by dot product)"},
        {"name": "stochastic_quantize_rows", "route": "cuda",
         "source": "pytorchrec_tpu_torch/csrc/quantize.cu",
         "replaces": "pytorchrec_tpu/ops/kernels/quantize.py:119",
         "launches": classic_launches["stochastic_quantize_rows"], "max_abs_err": b8_err,
         **b8_timing, "shape": f"rows [{n_scan}, {EMB}] f32, ids [{n_scan}] int32, the id-keyed "
                               f"bits made in the kernel (given_bits: bits [{n_scan}, {EMB}] "
                               f"uint32 from memory)",
         "deepfm_classic_train_launches": fm_classic_launches["stochastic_quantize_rows"],
         "serving_launches": 0,
         "library_note": "no single PyTorch call computes absmax, scale and stochastic "
                         "rounding to int8"},
        {"name": "bin_max_scores", "route": "cuda",
         "source": "pytorchrec_tpu_torch/csrc/retrieval_topk.cu",
         "replaces": "pytorchrec_tpu/ops/kernels/retrieval_topk.py:155",
         "launches": tt_serving_launches, "max_abs_err": b7_err,
         **{k: v for k, v in b7_timing[torch.bfloat16].items() if k != "exact_topk_ms"},
         "shape": f"q [{B7_QUERIES}, {TT_DIM}] f32 x items [{TT_ITEMS}, {TT_DIM}] bf16, tc "
                  f"{DEFAULT_TC}, group {DEFAULT_GROUP}",
         "f32": {"shape": f"items [{TT_ITEMS}, {TT_DIM}] f32", **b7_timing[torch.float32]},
         "exact_topk_ms": b7_timing[torch.bfloat16]["exact_topk_ms"],
         "f32_train_launches": tt_f32_launches["bin_max_scores"],
         "int8_train_launches": tt_int8_launches["bin_max_scores"],
         "library_note": "the per-super-chunk cuBLAS score GEMMs (torch.mm, f32 out) without "
                         "the selection; no single PyTorch call computes score + bin max"},
    ]
    fit_runs = {"f32": fit["f32"]["launches"], "int8": fit["int8"]["launches"],
                **{f"resume_{t}": fit[f"resume_{t}"]["launches"] for t in FIT_RESUME_TABLES}}
    for entry in entries:  # phase 37's runs, each counted from zero
        entry["fit_launches"] = {run: n.get(entry["name"], 0) for run, n in fit_runs.items()}
    for entry in entries:  # phase 38's captured runs (18 steps a path), each counted from zero
        if entry["name"] in ("segmented_sum_scan", "requantize_rows", "scatter_set_rows"):
            entry["zoo_launches"] = {path: zoo[path]["captured_launches"].get(entry["name"], 0)
                                     for path in (f"{n}_{t}" for n, t in ZOO_PATHS)}
    for entry in entries:  # phase 39's runs from files, each counted from zero
        entry["files_launches"] = {run: files[run]["launches"].get(entry["name"], 0)
                                   for run in FILES_RUNS}
    for entry in entries:  # phase 40's streaming Criteo runs, each counted from zero
        entry["criteo_launches"] = {run: criteo[run]["launches"].get(entry["name"], 0)
                                    for run in CRITEO_RUNS}
    phase41_runs = {**{run: dlrm[run] for run in dlrm if run.startswith("dlrm_")},
                    **dlrm["formats"]["contenders"]}
    for entry in entries:  # phase 41's captured runs, each counted from zero
        entry["phase41_launches"] = {run: out["launches"].get(entry["name"], 0)
                                     for run, out in phase41_runs.items()}
        checked = dlrm["against_plain"].get(entry["name"])
        if checked is not None:
            entry["phase41_max_abs_err"] = checked["max_abs_err"]
            entry["phase41_calls"] = checked["calls"]
    print(json.dumps({"deepfm": {"f32_ms_per_step": fm_f32_ms, "int8_ms_per_step": fm_int8_ms,
                                 "table_share_ms": shares},
                      "din": {"f32_ms_per_step": din_f32_ms, "int8_ms_per_step": din_int8_ms,
                              "batch": DIN_BATCH}}))
    print(json.dumps({"two_tower": {"f32_ms_per_step": tt_f32_ms, "int8_ms_per_step": tt_int8_ms,
                                    "batch": TT_BATCH, "fused_ms": tt_serving["fused_ms"],
                                    "exact_ms": tt_serving["exact_ms"],
                                    "recall": tt_serving["recall"],
                                    "index_build_ms": tt_serving["index_build_ms"]}}))
    print(json.dumps({"classic_int8": {
        "dcnv2_ms_per_step": classic_ms, "deepfm_ms_per_step": fm_classic_ms,
        "dcnv2_int4_ms_per_step": other_ms["classic_int4"],
        "dcnv2_two_groups_ms_per_step": other_ms["classic_g2"], "batch": TRAIN_BATCH,
        "b8_ms": b8_timing["ms"], "b8_given_bits_ms": b8_timing["given_bits"]["ms"],
        **classic_parts, "served": classic_served,
        "classic_vs_packed": classic_vs_packed}}))
    print(json.dumps({"capture": capture}))
    print(json.dumps({"capture_requests": requests_capture}))
    print(json.dumps({"fit": fit}))
    print(json.dumps({"zoo": zoo}))
    print(json.dumps({"files": files}))
    print(json.dumps({"criteo": criteo}))
    print(json.dumps({"phase41": dlrm}))
    phase42_runs = {run: out["launches"] for run, out in tasks.items()
                    if isinstance(out, dict) and "launches" in out}
    phase42_runs.update({f"optimizer_{run}": out["launches"]
                         for run, out in tasks["optimizers"].items()})
    for entry in entries:  # phase 42's runs, each counted from zero
        entry["phase42_launches"] = {run: launches.get(entry["name"], 0)
                                     for run, launches in phase42_runs.items()}
    print(json.dumps({"tasks": tasks}))
    for entry in entries:  # phase 43's bundles: the server's launches and the Python side's
        entry["phase43_launches"] = {
            name: {"server": bundles[name]["server"]["launches"].get(entry["name"], 0),
                   "python": bundles[name]["python_launches"].get(entry["name"], 0)}
            for name in BUNDLE_NAMES}
    print(json.dumps({"serving_bundle": bundles}))
    phase45_runs = {**{table: rl[table]["launches"] for table in RL_TABLES},
                    **{run: rl["cli"][run]["launches"] for run in RL_CLI_RUNS}}
    for entry in entries:  # phase 45's runs, each counted from zero
        entry["phase45_launches"] = {run: launches.get(entry["name"], 0)
                                     for run, launches in phase45_runs.items()}
        checked = rl["against_plain"].get(entry["name"])
        if checked is not None:
            entry["phase45_max_abs_err"] = checked["max_abs_err"]
            entry["phase45_calls"] = checked["calls"]
    print(json.dumps({"rl": rl}))
    for entry in entries:  # phase 46's runs, each counted from zero, mesh and none alike
        entry["phase46_launches"] = {table: mesh46[table]["launches"].get(entry["name"], 0)
                                     for table in MESH_TABLES}
        checked = mesh46["against_plain"].get(entry["name"])
        if checked is not None:
            entry["phase46_max_abs_err"] = checked["max_abs_err"]
    print(json.dumps({"mesh": {k: v for k, v in mesh46.items() if k != "against_plain"}}))
    for entry in entries:  # phase 47's runs, each counted from zero on each rank
        entry["phase47_launches"] = {run: [n.get(entry["name"], 0)
                                           for n in sharded[run]["launches"]]
                                     for run in SHARDED_RUNS if run not in PLAIN_SCAN_RUNS}
        checked = [r[entry["name"]]["max_abs_err"] for r in sharded["against_plain"]
                   if entry["name"] in r]
        if checked:
            entry["phase47_max_abs_err"] = max(checked)
    print(json.dumps({"sharded": {k: v for k, v in sharded.items() if k != "against_plain"}}))
    for entry in entries:  # phase 48's training run and fused requests, from zero on each rank
        entry["phase48_launches"] = {
            "train": [n.get(entry["name"], 0) for n in tt_mesh["launches"]],
            "fused_request": [n.get(entry["name"], 0) for n in tt_mesh["fused_launches"]]}
        checked = [r[entry["name"]]["max_abs_err"] for r in tt_mesh["against_plain"]
                   if entry["name"] in r]
        if entry["name"] == "bin_max_scores":
            checked = [r["b7_max_abs_err"] for r in tt_mesh["retrieval"]]
        if checked:
            entry["phase48_max_abs_err"] = max(checked)
    print(json.dumps({"tt_mesh": {
        "note": "host-clock ms over gloo, four ranks sharing one card: correctness figures",
        **{k: v for k, v in tt_mesh.items() if k != "against_plain"}}}))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
