#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (``metrics_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Device and build: the card's name and power limit; the CUDA kernels are
   built from ``metrics_tpu_torch/csrc`` with ``nvcc``.
2. Every kernel against its plain PyTorch version on the card (counts bit
   for bit, float sums within a stated tolerance) at the main path's
   shapes, on a ragged tail and on edge-case rows; then timed with CUDA
   events beside its bound, its plain version and (where one exists) a
   single PyTorch call computing the same function. ``confusion_counts`` is
   checked at C = 1, 2, 5, 20, 241 (the shared-memory route's limit), 242
   and 1000, on uniform keys, segmentation runs and indices out of range,
   in int32 and int64, at N = 0, 1, 4099 and 16,777,216, on views one
   element past an allocation and mixed and narrow dtypes, and timed at
   each C. ``binned_counts`` is
   also checked at T = 1, 5000 and 40,001 (the global-histogram path), on
   NaN, shuffled and log-spaced thresholds, equal preds, 81 classes, one
   row, 200,000 rows (partial rows and the finishing kernel) and on the CTR
   phase's own skewed scores, and timed at both path shapes; ``select_topk``
   at C = 1000 with k from 2 to 1000, at widths 1 to 1025, on an unaligned
   view and on rows all equal, NaN, -inf or signed zeros, with the path each
   case took. ``pairwise_reduce``
   is also held to the composition's answers on its edge cases (a NaN
   column on the masked diagonal, one row against itself) and launched
   twice at each path shape, where the row sums must be bit-identical.
   ``multilabel_counts`` is checked at 1, 3, 80, 81 and 1000 columns, at
   1 to 200,000 rows, on values 0-2 and int32's extremes, all zeros, all
   ones, no rows and an unaligned view. ``binned_calibration`` is checked
   at B = 1 to 65 (both sides of each instance of the private-bins kernel),
   on a single bin (every confidence 0.999, as from an over-confident
   classifier; timed beside the main shape), at N = 50,000 and 4,194,304
   (the cooperative grid), and every case but the atomics route's (past 64
   bins) is launched twice and must be bit-identical. The class windows of
   the sharded state plane (phase 16c): ``confusion_counts`` with
   ``rows=(5225, 5225)`` at C = 10,450 and N = 4,180 (and other windows,
   the empty one and the shared route's), ``multilabel_counts`` with
   ``cols=(9979, 9978)`` at [4,162, 19,957] (and a 16-byte-aligned
   window), each against its plain version and the slice of the
   whole-matrix kernel, timed beside ``torch.bincount`` of the window's
   fused index.
3. The main path: a ``MetricCollection`` of top-1 and top-5 accuracy,
   macro-F1 and the confusion matrix streams ImageNet-1k validation at full
   size (50,000 samples, 1000 classes, batches of 8192) through ``forward``,
   then ``compute()``; held against a numpy oracle, with the kernel launch
   counts of that run.
   The main path's updates run through the engine: the collection's
   ``forward`` is one fused program, captured as a CUDA graph at the first
   batch of each shape and replayed after (the run fails if a member fell
   back to its eager update); every later phase's updates go through the
   engine too, and each log line says how (``programs: ...``).
   Then the engine phase, on the same stream at full size: the collection
   six ways, (a) ``jit_update=False``, eager with the value checks; (b)
   eager with the checks skipped (the in-program flag); (c) the default, a
   captured fused update per batch; (d) ``jit_bucket="pow2"`` on a ragged
   stream of 8192, 5000, 3000 and 848 rows, repeated (one program per pow2
   bucket); (e) ``engine.drive`` over the stacked epoch with
   ``compute_in_trace=True``; (f) ``engine.drive`` over a host iterable of
   CPU batches (pinned, double-buffered copies). Each is run twice (the
   first pass captures, the second is timed) and held against the numpy
   oracle, its confusion counts bit for bit against (a), with ms per batch,
   device ms per batch, host syncs per batch, captures and cache hits,
   memory in use and the kernel launches, credited through graph replays
   and checked exactly. Then ``compute_async`` (one coalesced fetch),
   ``CalibrationError(streaming_bins=True)`` captured at 4,194,304
   confidences (the cooperative grid) against its eager twin, and the
   health policies: an ``on_bad_input="mask"`` macro F1 and an
   ``on_bad_input="skip"`` ``MeanMetric`` on a stream with NaN rows,
   against the oracle without them, with exact ``health_report()`` counts.
   Then copies on the card: the collection cloned mid-stream and fed the
   rest beside the original (equal results), and a pickle round trip of a
   CUDA multilabel ``ConfusionMatrix`` mid-stream (stays on ``cuda``, its
   updates launch ``multilabel_counts``, equal results).
   Then the sync phase, on the same ImageNet-1k val stream (rebuilt from a
   seed of its own in every process): a ``MetricCollection`` of top-1 and
   top-5 accuracy, macro F1, the confusion matrix, macro precision at
   top-5, micro recall, macro specificity, the Hamming distance, the mean
   and max of each sample's cross-entropy, the buffer of each sample's
   top-1 confidence and the harmonic mean of precision and recall built by
   the operators. (a) Two ranks, this script run twice with
   ``--sync-rank``, join a gloo group over TCP loopback with their metrics
   on ``cuda:0``; rank 0 streams batches 0, 2, 4 and 6, rank 1 batches 1,
   3 and 5, and each ``compute()`` syncs. Both ranks must give the same
   results, equal to one process's over the whole stream in rank-major
   order (counts and the confidence buffer bit for bit, scores within 1e-6
   relative, float sums within 1e-5 relative), and each rank's updates
   must launch ``select_topk`` and ``confusion_counts``. (b) That process
   then joins an NCCL group of one, and its ``compute()`` through NCCL must
   equal its unsynced result bit for bit. Each rank's ``compute()`` is
   timed with the sync and without it, and its collectives are counted.
   Each rank runs under a wall-clock limit and is killed past it.
4. Multilabel: ``ConfusionMatrix(multilabel=True)`` over MS-COCO 2014 val
   size (40,504 samples, 80 labels), held against a numpy oracle.
5. The curve and calibration path, each phase held against a numpy float64
   oracle with its launch counts:
   a. MS-COCO 2014 val multilabel curves: ``BinnedAveragePrecision`` and
      ``BinnedRecallAtFixedPrecision`` (80 labels, 200 thresholds) in one
      ``MetricCollection``;
   b. ImageNet-1k val calibration: ``CalibrationError(n_bins=15)``, streaming
      and buffered, over the softmax of phase 3's logits at temperature 1/4;
   c. binary AUROC at a CTR eval pass's scale (4,194,304 samples in batches
      of 65,536): ``AUROC(thresholds=200)`` beside the exact ``AUROC()``.
6. The pairwise path (the ``pairwise_reduce`` kernel), each call held
   against a numpy float64 oracle on 512 seeded rows, with its launch count:
   a. Stanford Online Products test split (60,502 images, 11,316 classes):
      ``pairwise_cosine_similarity(emb, reduction="mean")`` of 512-wide
      class-clustered embeddings against themselves, diagonal zeroed;
   b. In-Shop Clothes retrieval (14,218 queries, 12,612 gallery images,
      3,985 classes): ``pairwise_euclidean_distance(query, gallery,
      reduction="sum")``.
7. The regression path at the size of the NYU Depth v2 test split (654
   depth maps of 480 x 640, batches of 8): one ``MetricCollection`` of RMSE,
   MAE, MSLE, MAPE, SMAPE, R2, explained variance, Pearson, Tweedie
   (power 2) and Spearman through ``forward``, then ``compute()``; beside it
   ``CosineSimilarity(reduction="mean")`` over teacher and student features
   of ImageNet-1k val size (50,000 x 2048, batches of 8192). Each value is
   held against a numpy float64 oracle; the path runs no kernel.
8. A profile: each kernel's device time and device operations per wrapper
   call (its own kernels, and every device event of the call, the wrapper's
   fills included; one profile per call, so ``binned_counts`` at the CTR
   shape and ``confusion_counts`` at the segmentation shape are read
   apart), the launch floor (a one-element ``fill_``), and the device busy
   share (the union of the device events' intervals over the wall time),
   host syncs and top device ops of batches of each path.
9. The rest of classification and retrieval at full size (run right after
   the main path), each phase through ``MetricCollection.forward`` (the
   engine) and ``compute()``, held against a numpy float64 oracle, with its
   launches per kernel (exact, credited through graph replays), ms per
   batch, and the device ms, device events, host syncs and busy share of
   profiled batches, its ``programs: ...`` note (which members run eagerly,
   and why) and its seconds:
   a. ImageNet-1k val, phase 3's logits and a teacher's: ``CohenKappa``,
      ``MatthewsCorrCoef``, ``HingeLoss`` (Crammer-Singer and one-vs-all)
      and ``KLDivergence(log_prob=True)`` of the teacher's log-softmax
      against the student's (a distillation eval); ``confusion_counts`` at
      [8192, 1000], twice per batch, captured;
   b. five-grade ordinal labels at the size of the Kaggle Diabetic
      Retinopathy Detection test set (53,576 images, mostly grade 0, off by
      one grade more often than by two): quadratic- and linear-weighted
      ``CohenKappa``; counts bit for bit;
   c. semantic segmentation at Cityscapes val size (500 images of 1024 x
      2048 in batches of 8, ``[8, 20, 1024, 2048]`` float32 logits made on
      the card from the seed, skewed street-scene class shares in 32 x 32
      pixel regions, void mapped to class 19): ``JaccardIndex`` (mIoU and
      per class, void ignored), captured, ``confusion_counts`` at
      16,777,216 rows and C = 20, counts bit for bit against ``np.bincount``
      of labels copied to the host; ``dice_score`` on the first 4 batches;
      then that kernel at that shape against its plain version and
      ``torch.bincount``, timed;
   d. phase 5a's COCO curves, whose per-class computes are now one [C, T]
      pass: device events and device ms per batch;
   e. passage ranking at MS MARCO passage dev (small) size (6,980 queries x
      1,000 candidates, 14% without a relevant one, scores rounded to two
      decimals, rows shuffled within batches of 100 queries): the eight
      retrieval metrics in one collection (eager: list states, as in JAX),
      and ``RetrievalMAP(buffer_capacity=6,980,000)``, its update captured,
      equal to the unbounded member bit for bit; no kernel.
10. The wrappers, the state helpers and image quality (run after the
   regression path, so that the engine phase captures its own programs),
   each against a numpy oracle:
   a. the wrappers over ImageNet-1k val: ``BootStrapper`` of top-5
      accuracy and of ``MatthewsCorrCoef``, 100 multinomial replicates
      each, which must run on the captured fast path (one CUDA graph per
      input signature, replayed for every later batch; the run fails on a
      fallback): every replicate's counts bit for bit against an oracle that
      redraws the indices from a twin ``default_rng(seed)``, its value
      within 1e-6 relative, mean/std/quantiles within 1e-6, with ms/batch,
      device ms, host syncs, captures, the launches credited per replay
      (``select_topk`` or ``confusion_counts`` 100 times each) and the peak
      memory; a poisson ``BootStrapper`` (10 eager clones); ``MinMaxMetric``
      through ``forward``; ``ClasswiseWrapper(Recall(average=None))`` (1000
      keys); ``MetricTracker`` over the main path's collection for three
      epochs at three noise levels, ``best_metric(return_step=True)`` per
      member;
   b. ``MultioutputWrapper(MeanAbsoluteError(), num_outputs=3)`` over
      50,000 x 3 rows with 1% NaN rows, against numpy with those rows
      dropped per output;
   c. checkpoints on the card: the ImageNet collection saved after 3
      batches (``save_metric_state``), resumed in a fresh collection and fed
      the rest, bit-equal to the uninterrupted run; its state tree restored
      into a CPU collection; a restore into a 999-class confusion matrix
      refused with its state unchanged;
   d. image quality at DIV2K validation size (100 RGB images of 1020 x
      2040, batches of 4, made on the card): PSNR, SSIM and MS-SSIM, the
      first two images' SSIM and MS-SSIM against a float64 scipy oracle
      within 1e-5, each float32 value against the same metric in float64
      on the card within 1e-5, with ms per update and per ``compute()``,
      the compute's device time (the convolution's share) and peak memory.
11. Generative evaluation, after the kernels' profiles, through networks
   at full width with seeded random weights (the same draws as the JAX
   package's ``random_*_params``), written to a temporary ``.npz`` and
   loaded by the metrics as a user's weights would be:
   a. FID, KID (100 subsets of 1000) and IS (10 splits) at CIFAR-10 test
      size, reduced to 2,000 real and 2,000 generated uint8 images of 32 x 32 (smooth
      seeded fields made on the card; the generated set shifted and
      noised), batches of 500, resized to 299 x 299 by the TF1 matrices
      into InceptionV3. Checks: 32 images' features and logits within rtol
      1e-3, atol 2e-3 of a float64 copy of the network, and less their
      batch mean within ``NET_CENTRED_RTOL`` of it, which the same forward
      with TF32 on (the control) must miss; FID within 1e-5 of
      ``scipy.linalg.sqrtm`` of ``S1 S2`` on the card's own features; the
      Newton–Schulz FID within 1e-6 of a float64 re-statement of the
      iteration, and its distance to the eigh value logged against
      ``NEWTON_SCHULZ_FID_RTOL``; KID and IS within 1e-5 of numpy over the
      same subsets and splits; ``update_stream`` over the real set in
      chunks of 512 (a 464-row tail padded to 512) with exactly one
      captured ``encode_acc`` program, replayed by a second FID, its
      moments and FID within 1e-6 of ``update``'s; host batches, staged
      from pinned memory, give the same moments bit for bit. Logged: images/s, ms
      and summed kernel ms per batch, the busy share (the union of the
      kernels' intervals over the wall) and any overlapping kernels, host
      syncs, peak memory, each
      ``compute()``'s ms, top device ops (the convolutions' share), the
      multiply-add bound at 33.5e12 FMA/s, and one batch's forward in full
      float32 against TF32 and ``channels_last``.
   b. LPIPS, AlexNet and VGG16, over 1,000 pairs of 256 x 256 images in
      [-1, 1] (the second the first plus a seeded perturbation), batches
      of 50: 16 pairs within rtol 1e-4, atol 1e-5 of a float64 copy,
      identical pairs 0 within 1e-6, the streamed mean within 1e-6 of the
      per-pair mean; the same timings.
12. Text (phase 13), seeded synthetic corpora at the published sizes
   of the test sets, words drawn from a Zipf-distributed vocabulary of
   30,000, hypotheses the references with seeded substitutions, drops and
   insertions (and, for translation, one reversed 3-word span); every
   metric streams through ``forward`` (the first batch, held to the
   functional on it) and ``update`` with its state on the card, then
   ``compute()``; logged per metric: ms per update on the host clock, the
   device ms, busy share, host syncs and host-to-device copies of three
   profiled updates, ``compute()``'s ms and the peak memory:
   a. WMT14 newstest2014 en-de (3,003 segments, reduced to 500; Poisson 25 words,
      batches of 64): BLEU and SacreBLEU-13a (counters exact and scores
      within 1e-6 of a clipped n-gram oracle), chrF++, TER and EED (a
      second instance over the first 500 pairs within 1e-6 of the
      functional on the CPU);
   b. LibriSpeech test-clean (2,620 utterances, reduced to 1,000; about 5% word
      errors): WER, CER, MER, WIL, WIP against a plain Python
      (bit-parallel) Levenshtein, counts exact, scores within 1e-6;
   c. CNN/DailyMail 3.0.0 test (11,490 summaries, reduced to 4,000, of 3-4 sentences,
      batches of 32): ROUGE-1/2/L/Lsum, ``accumulate="best"``; ROUGE-1
      and -2 against a clipped overlap oracle, L and Lsum by the CPU prefix;
   d. SQuAD v1.1 dev size (10,570 questions, 1-3 ground truths, 2%
      unanswered and warned once, batches of 512): exact match and F1
      against an oracle of the official normalization;
   e. BERTScore on 13a's pairs through a seeded 17-layer encoder at
      roberta-large width (float32, TF32 off) and a CRC32 word-hash
      tokenizer, ``idf``, ``max_length=512``, batches of 64, four routes
      (functional, streamed module, module with a ``ShardedEncoder``,
      functional without length buckets): the first 64 pairs within 1e-5
      of float64 numpy on the card's own embeddings, the module within
      1e-6 and the other routes within 1e-5 of the functional, one
      captured ``encode`` program per ``(rows, width)`` signature, pow2
      buckets used, the baseline rescale exact; pairs/s, the encoder's
      and the matching's device ms, the multiply-add bound's share.
13. Audio and detection (phase 14), seeded data made on the card;
   every audio metric streams through ``forward`` (the first batch, held
   to its per-sample values) and ``update``, its ``compute()`` held to the
   mean of every per-sample value within 1e-5 relative; logged as in
   phase 13, with each metric's programs:
   a. Libri2Mix test size (3,000 mixtures of 2 speakers, 8 kHz, every
      utterance cut to 4 s, batches of 16): speech-like sources, estimates
      through a seeded 16-tap FIR with seeded leakage and noise; PIT over
      SI-SNR, then on the aligned estimates SI-SDR, SI-SNR, SNR, SDR
      (``filter_length=512``; its batched LU refuses capture, so its update
      runs eagerly, and the captures after it must still work), STOI
      (eager and ``jit_update=True``) and ESTOI. The first 64 mixtures
      against float64 numpy: closed forms within 1e-4 dB, PIT against a
      brute force, SDR against ``scipy.linalg.solve_toeplitz`` within 1e-3
      dB up to 25 dB (the error above logged), STOI and ESTOI within 2e-4
      of ``tests/helpers/stoi_oracle.py``, the resampler within 1e-4 of
      ``resample_poly``;
   b. DNS Challenge 2020 synthetic no-reverb test size (150 clips of 10 s
      at 16 kHz, seeded SNRs of 0-25 dB, batches of 10): SNR, SI-SDR, STOI
      and ESTOI (the 875-tap resampler), the first 20 clips against the
      same oracles; the PESQ constructor must raise its gate's error;
   c. COCO val2017 (5,000 images, reduced to 1,500 with the ground truths in
      proportion; 80 classes, 36,781 ground truths in
      COCO's area split, 100 detections an image, batches of 16,
      ``class_metrics``): ``MeanAveragePrecision`` on the card, with no host
      sync and no host-to-device copy in an update, equal bit for bit to a
      CPU instance on all 14 outputs, and a second instance over the
      first 200 images within 1e-6 of ``tests/helpers/coco_oracle.py``;
      update ms and its profile, state bytes, peak memory, ``compute()``
      seconds.
14. Observability (phase 15, last): the main path's collection, its
   programs already captured, streams ImageNet-1k val five passes each
   way: the event bus off; the bus on with unfenced tracing, which must
   give bitwise the same results, capture nothing new, keep the engine's
   counters, make 0 host syncs, emit one ``cache_hit`` event per replay,
   no ``kernel`` event and one ``forward`` span per batch; and fenced
   tracing, whose mean ``forward`` span must be at least the profiled
   device ms of a batch. ms/batch of each way. Then the run's events
   written with ``to_jsonl`` and counted by ``validate_jsonl``,
   ``prometheus_text(mc)`` parsed line by line, ``obs.snapshot()``'s
   ``kernels`` against ``kernel_stats()``, ``obs.snapshot(mc)`` against
   ``mc.obs_snapshot()`` and every legacy report, one new capture whose
   ``kernel`` events are its warm-up's and its capture's launches, a seeded
   ``ShardedEncoder`` stream of three chunks with a ragged tail (three
   ``encode`` events, their rows the real rows) and a NaN batch into a
   captured ``on_bad_input="raise"`` metric (one ``quarantine`` event,
   ``path="compiled"``, before the raise). The sync phase also holds each
   rank's ``sync_report()`` to the syncs and gathers it made, its bytes
   received to the other rank's bytes sent.
15. Sharded states (phase 16). The card is one device, so the mesh
   paths run two ways. (a) An NCCL group of one in this process, a
   ``(1, 1)`` ``("dp", "mp")`` ``DeviceMesh``: the main path's collection
   with ``drive(axis_name="dp")`` over 8 steps of 6,250 ImageNet-1k rows,
   and a ``ConfusionMatrix(class_sharding="mp")`` + macro
   ``StatScores(class_sharding="mp")`` collection with ``drive(mesh=,
   in_specs=P(None, "dp"))`` over ImageNet-21K-P val (10,450 classes,
   125 steps of 4,180): each bit for bit against its local drive, its
   chunks captured, 0 host syncs in the timed drive, and whether the NCCL
   collective ran inside the capture (``mesh_sync``). (b) Four gloo ranks
   on ``cuda:0`` (this script run with ``--shard-rank``) on a ``(2, 2)``
   mesh, each given the whole seeded epochs: the ImageNet-21K-P
   collection, each rank's ``[5225, 10450]`` shard equal to its rows of an
   ``np.bincount`` oracle, ``compute()`` equal to the oracle, resident bytes
   half the total; Open Images V6 val image-level labels (19,957 classes,
   10 steps of 4,162) through a class-split multilabel ``ConfusionMatrix``,
   each rank's columns against an oracle; FID with ``feature_sharding="mp"``
   at d = 2048 over 10,000 + 10,000 seeded features (each dp group half of
   them) within 1e-6 of the unsharded Newton–Schulz value and of its
   float64 re-statement; the main path's collection with
   ``axis_name="dp"`` on a ``(4,)`` mesh and ``axis_name=("host",
   "local"), hierarchical_sync=True`` on ``(2, 2)``, bit for bit against
   the local drive. Logged: ms per drive and per ``compute()``, the gloo
   all-reduce of a shard, the launches and programs, each rank's peak
   memory, the phase's seconds.

16. The encoder's mesh (phase 17, last). (a) An NCCL group of one in this
   process, a ``(1, 1)`` mesh: FID with ``encoder_sharding="mp"`` and
   ``feature_sharding="mp"`` over 12a's sets (2,000 real and
   2,000 generated images, InceptionV3 at full width) against the
   unsharded stream in turns, the moments and FID bit for bit, one captured
   program with the weights' gather inside it and no host sync; BERTScore
   over 13a's 500 pairs through 13e's encoder written as
   ``apply_fn(params, ids, mask)``, every 2-D weight split over ``mp``,
   within 1e-6 of the plain route. (b) Four gloo ranks on ``cuda:0``
   (``--encoder-rank``) on a ``(2, 2)`` mesh: the same FID on the first
   1,024 + 1,024 images (each dp group half), each rank's feature block
   equal to its slice of the unsharded features, FID equal on every rank
   and within 1e-6 of the unsharded value, the weights resident in halves;
   BERTScore through the encoder cut to 2 layers on 256 pairs within 1e-6
   of the unsharded route on every rank. Logged: images/s and pairs/s
   against the unsharded routes, ms per chunk, the gather's ms, resident
   bytes, the graph pool's reserved bytes, peak memory.

17. The resilient sync (phase 18, last). (a) Four gloo ranks on ``cuda:0``
   (this script run with ``--resilience-rank``, three launches of four, the
   fault plan in each rank's ``METRICS_TPU_FAULTS``) each stream a quarter
   of ImageNet-1k val, rank-major, through the main path's collection
   (launching ``select_topk`` and ``confusion_counts``) and a probe metric
   with a per-class sum of the logits tagged ``int8`` and two buffers of
   the top-1 confidence, one tagged ``bf16``, and sync them through a
   store ``ProcessGroup`` over the default ``TCPStore``. Run 1 (launch
   ``exact``): equal on every rank, to the one-process oracle (counts and
   the untagged buffer bit for bit, scores within 1e-6 relative), to the
   same ranks' sync over the gloo collective path bit for bit, the tagged
   leaves within ``error_bound`` of the exact values and bit for bit
   against the round trip of each rank's leaf; the ``wire`` events' ratio
   0.5 for bf16 and 0.254 for int8. Run 2 (``corrupt``, rank 1's payload
   corrupted twice a read): each reader retries twice, results run 1's bit
   for bit. Run 3 (``drop``, rank 3's payload dropped, ``on_sync_error=
   "partial"``, a 5 s deadline): ranks 0-2 report ``missing_ranks ==
   [3]``, ``degraded_partial == 1`` and ``"partial"``, their results the
   oracle over their own batches. Run 4 (launch ``exact``): rank 3 speaks
   wire v1 only; the group settles on v1 (``negotiation_stats()``) and the
   tagged leaves travel exact. (b) The probe through NCCL at world size 1:
   its codes' ``all_gather`` gives its local round trip bit for bit.
   Logged: each rank's ``compute()`` ms through the store, gloo and
   NCCL, bytes sent, ``backoff_s``, the phase's seconds.

18. The serving plane (phase 19, last), on the phase's seeded
   ImageNet-1k-shaped stream in requests of [64, 1000]. (a) A
   ``MetricBank`` of the main path's collection at capacity 512 (4.1 GB of
   confusion matrices): 512 tenants x 2 requests through
   ``RequestRouter(max_requests=256)``, 4 waves of 256, one captured
   program replayed: every tenant against the numpy oracle, 16 against a
   solo collection bit for bit, ``launches`` 4, 0 host syncs a replayed
   wave, the kernels' launches credited per replay, peak memory under 1.5x
   the bank's bytes plus its graph pool (the bank is not copied per wave);
   ``compute_async`` over every tenant in one fetch against
   ``compute_many``; dropping the bank releases its graph pool, with no
   ``clear_cache()``. (b) A child (``--serving-child DIR ACKS``) serves 32
   sessions through ``MetricBank(capacity=16, DiskStore,
   checkpoint_every_n_flushes=1)``, spilling and readmitting 16 a wave,
   acknowledges each wave and ``SIGKILL``s itself after wave 6; this
   process recovers every tenant, equal to the oracle over its
   acknowledged requests; the child's launches are 6 waves x 16 of each
   kernel, with no plain call. (c) A ``ConfusionMatrix(num_classes=1000)`` bank
   with ``audit_rate=1/4``: a bitflip inside a sampled flush is reported
   by ``IntegrityAuditor`` and repaired; a forged spilled blob fails its
   readmission. (d) ``MetricBank.drive`` of a top-5 ``Accuracy`` over
   ImageNet-1k val (captured, ``select_topk`` in every step) against the
   same tenant fed per flush and the main path's top-5, bit for bit. (e)
   ``sync_bank_states`` through NCCL at world size 1. (f) A wave whose
   capture the card refuses (its update waits for the card) raises and
   leaves every row and count of the bank as it was. Logged: ms per wave
   (host and device), requests/s banked against solo, the wave's device
   operations, the durable plane's time split (digest, encode, I/O),
   recovery seconds, bytes on disk, the phase's seconds.

19. Pod-scale banks (phase 20, last). Four gloo ranks on ``cuda:0`` (this
   script run with ``--pod-rank``) on a ``(2, 2)`` ``("host", "mp")``
   mesh, each building the same ``MetricBank`` of top-5 ``Accuracy`` and
   ``ConfusionMatrix(num_classes=1000, class_sharding="mp")`` at capacity
   256 a shard with ``tenant_axis="host"`` over one ``DiskStore`` (mesh
   rank 0 writes it): 512 tenants, 257 rows of a [500, 1000] confusion
   slice a rank (1.03 GB). Every rank holds the phase's seeded
   ImageNet-1k-shaped requests of [64, 1000] on the host and copies to the
   card only those it owns: 512 tenants x 2 requests in 4 waves of 256
   through ``RequestRouter(max_delay_s=None)``, then 32 tenants past the
   capacity (32 spills through the read exchange to rank 0's store), then
   ``recover()`` into a fresh pod bank. Checked: both kernels bit for bit
   against their plain versions at the phase's shapes; each rank's own
   rows against the numpy oracle bit for bit, read locally; each rank's
   launches of ``select_topk`` and ``confusion_counts`` equal its owned
   requests plus its captures' warm-up requests, with no plain call and 0
   host syncs a replayed wave; ``compute_many`` of 32 tenants and 16
   recovered tenants against solo collections bit for bit; every rank's
   ``summary()`` equal; ``del bank`` releases each rank's graph pool.
   Logged: a wave's host and device ms a rank, logical requests/s (the
   ranks share one card), the read exchange's ms, a spill's ms split into
   exchange, digest, encode and I/O, ``recover()`` s, peak memory and the
   graph pool a rank.

20. Warm starts and drive snapshots (phase 21, last), on a seeded
   ImageNet-1k val stream (50,000 x 1000 float32 logits), in fresh child
   processes (this script run with ``--warm-child ROLE DIR``), each with the
   persistent kernel cache in one directory (``METRICS_TPU_COMPILE_CACHE``).
   (a) ``record`` builds the kernel library there (one
   ``persistent_miss``), records a warmup manifest while the main path's
   collection takes two batches of 8192 and the 848-row tail twice through
   ``forward`` and two ``compute()``s, and a ``MetricBank`` of that
   collection at capacity 256 takes two waves of 256 requests of [64, 1000];
   ``cold`` serves the same with no manifest; ``warm`` times
   ``engine.warmup(manifest)`` and ``bank.warmup(manifest)``, then serves it.
   Checked: a cache hit with a build of 0.0 s in ``cold`` and ``warm``; no
   failed and every manifest program warmed, ``warmed_hits`` > 0, no stale
   program; each entry's first request makes 0 captures warm and at least
   one cold, and is faster warm (the ratio logged); the collection's values
   and every tenant's equal across the three bit for bit; then a
   [4096, 1000] batch raises a ``warmup_stale`` event naming ``avals``. (b)
   ``kill`` streams the epoch through ``engine.drive`` in chunks of 2 steps
   with ``snapshot_every=2`` into a ``DiskStore`` and is killed (SIGKILL)
   once the snapshot of step 4 is on disk; ``resume`` resumes it in a fresh
   process: its states, counts and ``compute()`` bit for bit equal to an
   uninterrupted drive here (after ``clear_cache()``), with no more captures
   than that drive; a snapshot forged with ``forge_snapshot_corruption``
   raises ``StateIntegrityError`` on resume. Both kernels against their plain
   versions at the phase's shapes. Logged: the build's seconds, each entry's
   first and second request cold and warm, the warmups' seconds, the drive's
   ms with and without snapshots, a snapshot's bytes, its seal and write ms,
   the resume's ms.

21. The elastic fleet (phase 22, last), on phase 19's seeded
   ImageNet-1k-shaped requests of [64, 1000], every fleet over a shared
   ``DiskStore`` with ``checkpoint_every_n_flushes=1``. (a) Workers 0-3 of
   the main path's collection at capacity 16, routers' ``max_requests``
   16, 48 tenants: round 1 (recorded into a warmup manifest), ``join(4,
   manifest=)``, round 2, ``kill(1)`` with its share of round 3 queued,
   the rest of round 3, ``die(2)``, ``leave(0)``, round 4 with a
   ``join(5)`` that a ``kill`` plan fells at its first admission, then
   ``compute_all()``. Checked: every tenant bit for bit against a solo
   collection fed the same requests in the same order, and its confusion
   matrix against ``np.bincount``; the rendezvous shape of every move map;
   the kill's re-submissions equal the queued requests; the die reads the
   store only; the warmed joiner's first flush captures nothing and no
   warm failed; each decommission and the die free at least the departed
   bank's bytes, and ``del fleet`` returns the card to the phase's start
   within 64 MiB. (b) A fresh fleet of 4 workers, 4 tenants each in waves
   of 4: the median healthy flush measured, then ``latency_threshold_ms``
   at twice it and a ``slow`` plan on worker 3 at four times it: worker 3
   walks to probation and ejection, no other worker leaves healthy, the
   hedges of its queued requests are delivered and applied exactly once
   (``duplicates_applied == 0``), tenants bit for bit; then a
   ``ConfusionMatrix(1000)`` fleet with ``audit_rate=1`` and a ``bitflip``
   plan on worker 1, ejected through its failed audits, its tenants bit
   for bit over their acked requests. (c) ``rolling_upgrade`` of 3 workers,
   once clean and once with a canary that corrupts its state and is rolled
   back; no acked request lost. (d) ``KVLedger`` over the default
   ``TCPStore`` of a gloo world of one: a join that moves every tenant the
   joiner owns. Logged: each membership change's ms split into drain,
   export, publish and admit, its moves and bytes, the memory it freed; the
   kill's and the die's recovery ms; the joiner's first flush warm against
   the first workers' cold ones; the healthy flush against the guard's
   default 250 ms; the guard's walk; a move's ms through the store; the
   phase's seconds. Phase 16b's ranks also move the main path's
   ``ConfusionMatrix(1000, class_sharding="mp")`` from the ``(2, 2)`` mesh
   to ``(1, 4)`` and back with ``reshard_onto(verify=True)``, bit for bit.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the per-kernel JSON record. Any failure raises and exits non-zero. Without
CUDA the script exits 2 and prints no result.
"""
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

SEED = 0
BATCH = 8192
IMAGENET_VAL = (50_000, 1000)  # ILSVRC2012 val: samples, classes
COCO_VAL = (40_504, 80)  # MS-COCO 2014 val: images, labels
TOP_K = 5
RAGGED = 848  # 50,000 - 6 * 8192
COCO_RAGGED = 7736  # 40,504 - 4 * 8192
THRESHOLDS = 200  # tf.keras.metrics.AUC's default num_thresholds
CAL_BINS = 15  # CalibrationError's default (Guo et al. 2017)
# softmax temperature 1/4 on the ImageNet logits: top-1 confidences spread over
# the 15 bins, their mean (about 0.56) above top-1 accuracy (about 0.41), as an
# uncalibrated classifier's are (Guo et al. 2017)
CAL_LOGIT_SCALE = 4.0
MIN_PRECISION = 0.9
CTR_EVAL = (4_194_304, 65_536)  # binary samples, batch
SOP_TEST = (60_502, 11_316)  # Stanford Online Products test split: images, classes
INSHOP = (14_218, 12_612, 3_985)  # In-Shop Clothes retrieval: queries, gallery images, classes
EMB_DIM = 512  # embedding width of the deep-metric-learning literature on both sets
ORACLE_ROWS = 512
NYU_TEST = (654, 480, 640)  # NYU Depth v2 test split: depth maps, height, width
NYU_BATCH = 8
FEATURES = (50_000, 2048, 8192)  # ImageNet-1k val teacher/student features: samples, width, batch

# NVIDIA H100 SXM data sheet: the HBM rate, the CUDA cores' instruction rate
# (132 SMs x 128 lanes x 1.98 GHz; the sheet's 67 TFLOP/s float32 counts an
# FMA as two) and the tensor cores' dense TF32 rate. No tensor-core type
# applies to the integer and compare workloads, whose every compare or add
# is one instruction. Euclidean row sums need every cell's 2 d flops (the
# square root is not linear), and the pairwise kernel runs them on the
# tensor cores in TF32; cosine row sums are linear and need only
# O((N + M) d), so their bound is bytes.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 33.5e12
TF32_FLOPS_PER_S = 495e12


def _log(msg: str) -> None:
    print(msg, flush=True)


def _bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = CUDA_CORE_OPS_PER_S):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events (so it includes the host's launch cost when that is the longer)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _max_abs_err(torch, name: str, got, want) -> float:
    """Max |kernel - plain|; raises unless the two are bit-identical."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: kernel gives {got.dtype}{tuple(got.shape)}, plain {want.dtype}{tuple(want.shape)}")
    err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
    if err != 0.0 or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel and plain version differ (max abs err {err})")
    return err


def _topk_edge_rows(rng: np.random.Generator, rows: int, c: int) -> np.ndarray:
    """NaN, +-inf, runs of ties, mixed -0.0/0.0 and rows with fewer than k finite values."""
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, -1.0, 0.5], np.float32)
    x = np.empty((rows, c), np.float32)
    for r in range(rows):
        kind = r % 6
        if kind == 0:  # runs of ties
            x[r] = rng.integers(0, 3, c)
        elif kind == 1:  # scattered NaN and +inf in normal noise
            x[r] = rng.standard_normal(c)
            x[r, rng.choice(c, 7, replace=False)] = np.nan
            x[r, rng.choice(c, 3, replace=False)] = np.inf
        elif kind == 2:  # fewer than k finite values
            x[r] = -np.inf
            x[r, rng.choice(c, r % 4, replace=False)] = rng.standard_normal(r % 4)
        elif kind == 3:  # signed zeros below a few negatives
            x[r] = np.where(rng.random(c) < 0.5, -0.0, 0.0)
            x[r, rng.choice(c, 5, replace=False)] = -1.0
        elif kind == 4:  # all NaN
            x[r] = np.nan
        else:
            x[r] = rng.choice(specials, c)
    return x


# confusion_counts' sweep: C on both sides of the shared route's limit (241)
CC_SWEEP_C = (1, 2, 5, 20, 241, 242, 1000)
CC_SWEEP_N = (0, 1, 4099, 16_777_216)  # none, one, a ragged tail (N % 4 = 3), the segmentation batch


def _run_labels(rng, n: int, c: int):
    """Segmentation-shaped labels: one class per run of SEG_BLOCK samples,
    class 0 on a third of the runs (the road), the rest uniform; predictions
    equal to them but for SEG_ERROR of the samples."""
    runs = (n + SEG_BLOCK - 1) // SEG_BLOCK
    cls = np.where(rng.random(runs) < 1 / 3, 0, rng.integers(0, c, runs))
    target = np.repeat(cls, SEG_BLOCK)[:n]
    preds = np.where(rng.random(n) < SEG_ERROR, rng.integers(0, c, n), target)
    return preds, target


def _confusion_sweep(torch, rng) -> float:
    """``confusion_counts`` against its plain version, bit for bit, at every C
    of CC_SWEEP_C: uniform keys, segmentation runs and indices out of range,
    int32 and int64, N of CC_SWEEP_N; views one element past an allocation
    (not 16-byte aligned: one index per load); mixed and narrow dtypes (cast
    to int64). Then the kernel's time
    at each C on N = 16,777,216 int64 runs and uniform keys."""
    from metrics_tpu_torch.ops import confusion_counts as cc

    dev = torch.device("cuda")
    big = CC_SWEEP_N[-1]
    errs, routes, timed = [], {}, {}

    def check(tag, p, t, c):
        errs.append(_max_abs_err(torch, f"confusion_counts[{tag}]", cc._confusion_counts_cuda(p, t, c), cc._confusion_counts_plain(p, t, c)))

    for c in CC_SWEEP_C:
        route, copies = cc._confusion_route(c)
        routes[c] = f"{route}/{copies}"
        data = {
            "uniform": (rng.integers(0, c, big), rng.integers(0, c, big)),
            "runs": _run_labels(rng, big, c),
            "out_of_range": (rng.integers(-3, c + 3, big), rng.integers(-3, c + 3, big)),
        }
        on_card = {dist: (torch.from_numpy(p).to(dev), torch.from_numpy(t).to(dev)) for dist, (p, t) in data.items()}
        for dist, (p64, t64) in on_card.items():
            for dtype in (torch.int32, torch.int64):
                p, t = p64.to(dtype), t64.to(dtype)
                for n in CC_SWEEP_N:
                    check(f"c{c}/{dist}/{dtype}/n{n}", p[:n], t[:n], c)
                if dist == "runs":
                    for n in (4099, big):
                        shifted = torch.cat([p.new_zeros(1), p[:n]])[1:]
                        check(f"c{c}/runs/{dtype}/n{n}/offset_view", shifted, t[:n], c)
                        check(f"c{c}/runs/{dtype}/n{n}/offset_views", shifted, torch.cat([t.new_zeros(1), t[:n]])[1:], c)
        p64, t64 = on_card["runs"]
        check(f"c{c}/runs/mixed", p64.int(), t64, c)
        if c <= 255:
            check(f"c{c}/runs/uint8", p64.to(torch.uint8), t64.to(torch.uint8), c)
        timed[c] = tuple(
            round(_cuda_ms(torch, lambda p=p, t=t: cc._confusion_counts_cuda(p, t, c), iters=10), 4)
            for p, t in (on_card["runs"], on_card["uniform"])
        )
    bound_ms, _ = _bound_ms(2 * big * 8, 5 * big)
    _log(
        f"confusion_counts: bit-identical to plain on {len(errs)} cases; route/copies per C {routes}; ms at N={big} int64"
        f" (segmentation runs, uniform keys) per C {timed}, against the byte bound {bound_ms:.4f} ms"
    )
    return max(errs)


def check_and_time_kernels(torch, rng):
    from metrics_tpu_torch.ops import confusion_counts as cc
    from metrics_tpu_torch.ops import select_topk as st

    dev = torch.device("cuda")
    n, c = BATCH, IMAGENET_VAL[1]
    ml_c = COCO_VAL[1]
    records = {}

    # confusion_counts: main-path shape, then the sweep over both routes
    preds = torch.from_numpy(rng.integers(0, c, n)).to(dev)
    target = torch.from_numpy(rng.integers(0, c, n)).to(dev)
    err = _max_abs_err(torch, "confusion_counts[main]", cc._confusion_counts_cuda(preds, target, c), cc._confusion_counts_plain(preds, target, c))
    errs = [err, _confusion_sweep(torch, rng)]
    ms = _cuda_ms(torch, lambda: cc._confusion_counts_cuda(preds, target, c))
    plain_ms = _cuda_ms(torch, lambda: cc._confusion_counts_plain(preds, target, c))
    library_ms = _cuda_ms(torch, lambda: torch.bincount(target * c + preds, minlength=c * c))
    bound_ms, bound_by = _bound_ms(2 * n * 8 + c * c * 8, 5 * n)
    records["confusion_counts"] = dict(
        source="metrics_tpu_torch/csrc/confusion_counts.cu",
        replaces="metrics_tpu/ops/confusion_counts.py:44",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        shape=f"N={n}, C={c}",
    )

    # multilabel_counts: main-path shape (COCO width), ragged tail; widths on
    # both sides of the 16-byte path (C % 4) and of a 16-column tile; one
    # row to 200,000 rows (past 16 chunks of a cluster); values 0-2 and the
    # extremes of int32 (exact int64 products); all zeros and all ones; a
    # view one element past an allocation (not 16-byte aligned); no rows
    errs = []
    mp = torch.from_numpy(rng.integers(0, 2, (n, ml_c), dtype=np.int32)).to(dev)
    mt_ = torch.from_numpy(rng.integers(0, 2, (n, ml_c), dtype=np.int32)).to(dev)

    def labels(rows: int, cols: int, high: int = 2):
        return torch.from_numpy(rng.integers(0, high, (rows, cols), dtype=np.int32)).to(dev)

    ml_cases = {"main": (mp, mt_), "ragged": (mp[:RAGGED], mt_[:RAGGED])}
    ml_cases.update({f"c{w}": (labels(n, w), labels(n, w)) for w in (1, 3, 81, 1000)})
    ml_cases.update({f"n{r}": (labels(r, ml_c), labels(r, ml_c)) for r in (1, 200_000)})
    ml_cases["values_0_2"] = (labels(n, ml_c, 3), labels(n, ml_c, 3))
    extremes = torch.tensor([-(2**31), -1, 0, 1, 2**31 - 1], dtype=torch.int32, device=dev)
    ml_cases["int32_extremes"] = tuple(extremes[labels(1000, ml_c, 5).long()] for _ in range(2))
    ml_cases["all_zeros"] = (torch.zeros_like(mp), torch.zeros_like(mt_))
    ml_cases["all_ones"] = (torch.ones_like(mp), torch.ones_like(mt_))
    ml_cases["offset_view"] = (torch.cat([mp.new_zeros(1), mp.reshape(-1)])[1:].view(n, ml_c), mt_)
    ml_cases["n0"] = (mp[:0], mt_[:0])
    ml_routes = {}
    for tag, (p, t) in ml_cases.items():
        errs.append(_max_abs_err(torch, f"multilabel_counts[{tag}]", cc._multilabel_counts_cuda(p, t), cc._multilabel_counts_plain(p, t)))
        lanes, vec = cc._multilabel_route(p.shape[1], p.data_ptr(), t.data_ptr())
        ml_routes[tag] = f"{lanes}x{'16B' if vec else '4B'}"
    _log(f"multilabel_counts: bit-identical to plain on {len(ml_cases)} cases; lanes per row x load width per case {ml_routes}")
    ms = _cuda_ms(torch, lambda: cc._multilabel_counts_cuda(mp, mt_))
    plain_ms = _cuda_ms(torch, lambda: cc._multilabel_counts_plain(mp, mt_))
    # one torch.bincount over the combined key (column, target, pred), as row 1 times its own
    ml_cols = torch.arange(ml_c, device=dev, dtype=torch.int32)
    library_ms = _cuda_ms(torch, lambda: torch.bincount(((ml_cols * 2 + mt_) * 2 + mp).view(-1), minlength=4 * ml_c))
    bound_ms, bound_by = _bound_ms(2 * n * ml_c * 4 + ml_c * 4 * 8, 3 * n * ml_c)
    records["multilabel_counts"] = dict(
        source="metrics_tpu_torch/csrc/confusion_counts.cu",
        replaces="metrics_tpu/ops/confusion_counts.py:109",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        shape=f"N={n}, C={ml_c}",
    )

    # select_topk: main-path shape, ragged tail, edge rows, half inputs, a
    # row too wide for the register kernel and for the default 48 KB of
    # shared memory; every k from 2 to C at the main width; widths on both
    # sides of each register instance's limit and of the 16-byte path's
    # (C % 4); a view one element past an allocation (not 16-byte aligned)
    errs = []
    x = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32)).to(dev)
    edge = torch.from_numpy(_topk_edge_rows(rng, 600, c)).to(dev)
    wide = torch.from_numpy(_topk_edge_rows(rng, 48, 20_000)).to(dev)
    x64 = x.double() + torch.from_numpy(rng.standard_normal((n, c)) * 1e-9).to(dev)  # ties only float64 separates
    cases = {"main": (x, TOP_K), "ragged": (x[:RAGGED], TOP_K), "bf16": (x.bfloat16(), TOP_K), "f16": (x.half(), 3)}
    cases.update({"f64": (x64, TOP_K), "f64_edge": (edge.double(), 5), "f64_wide": (wide.double(), 7)})
    cases.update({f"edge_k{k}": (edge, k) for k in (2, 5, 64)})
    cases["wide_k7"] = (wide, 7)
    cases.update({f"c{c}_k{k}": (x[:512], k) for k in (2, 5, 64, 500, 1000)})
    narrow = torch.from_numpy(_topk_edge_rows(rng, 300, 1025)).to(dev)
    cases.update({f"c{w}": (narrow[:, :w].contiguous(), min(w, 3)) for w in (1, 3, 31, 33, 998, 1024, 1025)})
    cases["offset_view"] = (torch.cat([x.new_zeros(1), x[:300].reshape(-1)])[1:].view(300, c), TOP_K)
    cases["all_equal"] = (torch.full((64, c), 0.25, device=dev), 7)
    cases["all_nan"] = (torch.full((64, c), float("nan"), device=dev), 7)
    cases["all_neg_inf"] = (torch.full((64, c), -np.inf, device=dev), 7)
    cases["signed_zeros"] = (torch.where(torch.from_numpy(rng.random((64, c)) < 0.5).to(dev), -0.0, 0.0), 9)
    routes = {}
    for tag, (v, k) in cases.items():
        errs.append(_max_abs_err(torch, f"select_topk[{tag}]", st._topk_mask_cuda(v, k), st._topk_mask_plain(v, k)))
        w = v if v.dtype == torch.float64 else v.float().contiguous()
        route, keys, vec = st._topk_route(w.dtype, w.shape[1], w.data_ptr())
        routes[tag] = route if route != "registers" else f"registers/{keys}{'/16B' if vec else '/4B'}"
    _log(f"select_topk: bit-identical to plain on {len(cases)} cases; path per case {routes}")
    ms = _cuda_ms(torch, lambda: st._topk_mask_cuda(x, TOP_K))
    plain_ms = _cuda_ms(torch, lambda: st._topk_mask_plain(x, TOP_K), iters=10)
    library_ms = _cuda_ms(
        torch, lambda: torch.zeros(x.shape, dtype=torch.int32, device=dev).scatter_(1, torch.topk(x, TOP_K).indices, 1)
    )
    bound_ms, bound_by = _bound_ms(n * c * 4 + n * c * 4, n * c * TOP_K)
    ms64 = _cuda_ms(torch, lambda: st._topk_mask_cuda(x64, TOP_K))
    plain_ms64 = _cuda_ms(torch, lambda: st._topk_mask_plain(x64, TOP_K), iters=10)
    bound64, _ = _bound_ms(n * c * 8 + n * c * 4, n * c * TOP_K)
    _log(f"kernel select_topk ([{n}, {c}] f64, k={TOP_K}): ms={ms64:.4f} plain_ms={plain_ms64:.4f} bound_ms={bound64:.4f}")
    records["select_topk"] = dict(
        source="metrics_tpu_torch/csrc/select_topk.cu",
        replaces="metrics_tpu/ops/select_topk.py:38",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        shape=f"[{n}, {c}] f32, k={TOP_K}",
    )
    for name, rec in records.items():
        lib = "n/a" if rec["library_ms"] is None else f"{rec['library_ms']:.4f}"
        _log(
            f"kernel {name} ({rec['shape']}): bit-identical to plain on all cases; ms={rec['ms']:.4f}"
            f" plain_ms={rec['plain_ms']:.4f} library_ms={lib} bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']})"
        )
    calls = {
        "confusion_counts": lambda: cc._confusion_counts_cuda(preds, target, c),
        "multilabel_counts": lambda: cc._multilabel_counts_cuda(mp, mt_),
        "select_topk": lambda: st._topk_mask_cuda(x, TOP_K),
    }
    return records, calls


def _binned_counts_cases(torch, rng, dev):
    """``name -> (preds, target, thresholds)`` at the curve path's shapes and on edge inputs."""
    n, c = BATCH, COCO_VAL[1]
    grid = torch.linspace(0, 1, THRESHOLDS, device=dev)
    probs = torch.from_numpy(rng.random((n, c), dtype=np.float32)).to(dev)
    labels = torch.from_numpy((rng.random((n, c)) < 3 / c).astype(np.int32)).to(dev)
    ctr = torch.from_numpy(rng.random((CTR_EVAL[1], 1), dtype=np.float32)).to(dev)
    ctr_labels = torch.from_numpy((rng.random((CTR_EVAL[1], 1)) < 0.25).astype(np.int32)).to(dev)
    with_nan = probs.clone()
    with_nan[torch.from_numpy(rng.random((n, c)) < 0.01).to(dev)] = float("nan")
    on_grid = grid[torch.from_numpy(rng.integers(0, THRESHOLDS, (n, c))).to(dev)]  # preds exactly on thresholds
    shuffled = torch.cat([grid[torch.randperm(THRESHOLDS, device=dev)], grid[:17], torch.tensor([-np.inf, np.inf, np.nan], device=dev)])
    nan_ths = torch.cat([grid[:100], torch.tensor([np.nan, 0.5, np.nan, -np.inf], device=dev), grid[100:]])
    skewed, clicked = _ctr_scores(rng, CTR_EVAL[1])
    big_col = torch.from_numpy(rng.random((200_000, 1), dtype=np.float32)).to(dev)
    big_col_labels = torch.from_numpy((rng.random((200_000, 1)) < 0.25).astype(np.int32)).to(dev)
    c81 = torch.from_numpy(rng.random((n, 81), dtype=np.float32)).to(dev)
    c81_labels = torch.from_numpy((rng.random((n, 81)) < 3 / 81).astype(np.int32)).to(dev)
    return {
        "main": (probs, labels, grid),
        "ragged": (probs[:COCO_RAGGED], labels[:COCO_RAGGED], grid),
        "ctr_shape": (ctr, ctr_labels, grid),
        "nan_preds": (with_nan, labels, grid),
        "on_grid": (on_grid, labels, grid),
        "unsorted_repeated": (on_grid, labels, shuffled),
        "bf16": (on_grid.bfloat16(), labels, grid),
        "f16": (probs.half(), labels, grid),
        "f64": (on_grid.double() + 1e-12, labels, grid),  # above a grid point only in float64
        "f64_thresholds": (probs, labels, grid.double()),
        "all_positive": (probs, torch.ones_like(labels), grid),
        "all_negative": (probs, torch.zeros_like(labels), grid),
        "int64_target": (probs, labels.long() * 3 - 1, grid),  # positive means > 0
        "ctr_skewed": (torch.from_numpy(skewed[:, None]).to(dev), torch.from_numpy(clicked[:, None].astype(np.int32)).to(dev), grid),
        "t1": (probs, labels, grid[THRESHOLDS // 3 : THRESHOLDS // 3 + 1]),
        "t40001_global_histogram": (probs[:512], labels[:512], torch.linspace(0, 1, 40_001, device=dev)),
        "t5000_ranked_by_kernel": (on_grid[:2048], labels[:2048], torch.linspace(0, 1, 5000, device=dev).flip(0)),
        "t5000_ascending": (probs[:2048], labels[:2048], torch.linspace(0, 1, 5000, device=dev)),
        "log_grid": (probs, labels, torch.logspace(-6, 0, THRESHOLDS, device=dev)),  # uneven: bins found by search
        "n200000_c1_partial_rows": (big_col, big_col_labels, grid),  # past the cluster path's rows
        "nan_thresholds": (with_nan, labels, nan_ths),
        "all_preds_equal": (torch.full_like(probs, 0.5), labels, grid),
        "c81_ragged_tile": (c81, c81_labels, grid),
        "misaligned_view": (probs.reshape(-1)[1:].reshape(-1)[: n * 79].view(n, 79), labels[:, :79].contiguous(), grid),
        "n1": (probs[:1], labels[:1], grid),
        "n1_c1": (ctr[:1], ctr_labels[:1], grid),
        "f64_t40001": (probs[:256].double(), labels[:256], torch.linspace(0, 1, 40_001, device=dev)),
    }


def _top1_calibration(torch, logits, target):
    """The calibration phase's softmax, and its top-1 confidences and correctness."""
    probs = torch.softmax(logits * CAL_LOGIT_SCALE, dim=1)
    return probs, probs.amax(dim=1), (probs.argmax(dim=1) == target).float()


def _calibration_cases(torch, rng, dev):
    """``name -> (confidences, accuracies, boundaries)`` at the calibration path's shapes and on edge inputs."""
    n = BATCH
    logits, target = _imagenet_stream(rng, n)  # one batch of what the calibration phase feeds the kernel
    _, conf, acc = _top1_calibration(torch, torch.from_numpy(logits).to(dev), torch.from_numpy(target).to(dev))
    b15 = torch.linspace(0, 1, CAL_BINS + 1, device=dev)
    edge = conf.clone()
    pick = torch.from_numpy(rng.integers(0, CAL_BINS + 1, n)).to(dev)
    specials = torch.tensor([0.0, 1.0, 1.5, np.inf, -0.5, -np.inf, np.nan], device=dev)
    kind = torch.from_numpy(rng.integers(0, 3, n)).to(dev)
    edge = torch.where(kind == 0, b15[pick], edge)  # exactly on float32 boundaries
    edge = torch.where(kind == 1, specials[torch.from_numpy(rng.integers(0, len(specials), n)).to(dev)], edge)
    big = torch.from_numpy(rng.random(CTR_EVAL[0], dtype=np.float32)).to(dev)
    return {
        "main_b15": (conf, acc, b15),
        "b5000": (conf, acc, torch.linspace(0, 1, 5001, device=dev)),
        "ragged": (conf[:RAGGED], acc[:RAGGED], b15),
        "edge_b15": (edge, acc, b15),
        "edge_b5000": (edge, acc, torch.linspace(0, 1, 5001, device=dev)),
        "b20000_global_atomics": (edge, acc, torch.linspace(0, 1, 20001, device=dev)),
        "imagenet_size": (torch.from_numpy(rng.random(IMAGENET_VAL[0], dtype=np.float32)).to(dev), torch.ones(IMAGENET_VAL[0], device=dev), b15),
        # every confidence in the top bin, as from an over-confident classifier
        "one_bin": (torch.full((n,), 0.999, device=dev), acc, b15),
        # both sides of each instance of the private-bins kernel (K = 16, 32,
        # 64) and past it (the atomics kernel)
        **{f"b{b}": (conf, acc, torch.linspace(0, 1, b + 1, device=dev)) for b in (1, 16, 31, 32, 33, 64, 65)},
        "n4194304": (big, (torch.from_numpy(rng.random(big.numel()) < 0.4).to(dev)).float(), b15),  # the cooperative grid
        "n4194304_one_bin": (torch.full_like(big, 0.999), torch.ones_like(big), b15),
        "offset_view": (conf[1:], acc[1:], b15),  # not 16-byte aligned
        "n1": (conf[:1], acc[:1], b15),
        "n0": (conf[:0], acc[:0], b15),
    }


def _sums_err(torch, name: str, got, want) -> float:
    """Max |kernel - plain| of a float32 sum; raises beyond 1e-5 relative (NaN
    where both are NaN): the kernel adds in float32 in its own order, the
    plain version in float64, rounded once."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: kernel gives {got.dtype}{tuple(got.shape)}, plain {want.dtype}{tuple(want.shape)}")
    if not torch.allclose(got, want, rtol=1e-5, atol=0.0, equal_nan=True):
        raise AssertionError(f"{name}: kernel and plain sums differ beyond 1e-5 relative")
    both = ~(torch.isnan(got) & torch.isnan(want)) & ~(torch.isinf(got) & (got == want))
    return (got[both].double() - want[both].double()).abs().max().item() if both.any() else 0.0


def check_and_time_binned(torch, rng):
    from metrics_tpu_torch.ops import binned_counts as bc

    dev = torch.device("cuda")
    records = {}
    cases = _binned_counts_cases(torch, rng, dev)
    errs = []
    for tag, args in cases.items():
        for name, got, want in zip(("tp", "fp", "fn", "tn"), bc._binned_counts_cuda(*args), bc._binned_counts_plain(*args)):
            errs.append(_max_abs_err(torch, f"binned_counts[{tag}].{name}", got, want))
    n, c = cases["main"][0].shape
    main = cases["main"]

    def bound(rows: int, cols: int):
        """Bytes bound of one call: preds and target read, thresholds read, four
        [C, T] int64 written; operations N*C*ceil(log2(T + 1)) compares."""
        return _bound_ms(2 * rows * cols * 4 + THRESHOLDS * 4 + 4 * cols * THRESHOLDS * 8, rows * cols * np.ceil(np.log2(THRESHOLDS + 1)))

    bound_ms, bound_by = bound(n, c)
    records["binned_counts"] = dict(
        source="metrics_tpu_torch/csrc/binned_counts.cu",
        replaces="metrics_tpu/ops/binned_counts.py:51",
        max_abs_err=max(errs), ms=_cuda_ms(torch, lambda: bc._binned_counts_cuda(*main)),
        plain_ms=_cuda_ms(torch, lambda: bc._binned_counts_plain(*main), iters=10),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None, shape=f"[{n}, {c}] f32, T={THRESHOLDS}",
    )
    _log(
        f"kernel binned_counts ([{n}, {c}] f32, T={THRESHOLDS}): the first design's N*C*T compare floor"
        f" {n * c * THRESHOLDS / CUDA_CORE_OPS_PER_S * 1e3:.4f} ms (operations), not the function's bound"
    )
    ctr_bound, ctr_by = bound(CTR_EVAL[1], 1)
    for tag in ("ctr_shape", "ctr_skewed"):
        args = cases[tag]
        _log(
            f"kernel binned_counts ([{CTR_EVAL[1]}, 1] f32, T={THRESHOLDS}, {'uniform' if tag == 'ctr_shape' else 'CTR-skewed'} scores):"
            f" ms={_cuda_ms(torch, lambda: bc._binned_counts_cuda(*args)):.4f}"
            f" plain_ms={_cuda_ms(torch, lambda: bc._binned_counts_plain(*args), iters=10):.4f} bound_ms={ctr_bound:.5f} ({ctr_by})"
        )

    errs = []
    cal_cases = _calibration_cases(torch, rng, dev)
    cal_routes = {}
    for tag, args in cal_cases.items():
        got, want = bc._binned_calibration_cuda(*args), bc._binned_calibration_plain(*args)
        _max_abs_err(torch, f"binned_calibration[{tag}].count", got[0], want[0])
        errs += [_sums_err(torch, f"binned_calibration[{tag}].{name}", g, w) for name, g, w in zip(("conf_sum", "acc_sum"), got[1:], want[1:])]
        route, regs, vec = bc._calibration_route(args[0].numel(), args[2].numel() - 1, args[0].data_ptr(), args[1].data_ptr())
        again = bc._binned_calibration_cuda(*args)
        # a second launch on the same inputs, bit for bit (NaN sums included);
        # past 64 bins the atomics kernel promises only the tolerance
        bits = [(g.view(torch.int32), h.view(torch.int32)) if g.is_floating_point() else (g, h) for g, h in zip(got, again)]
        if route != "atomics" and not all(torch.equal(g, h) for g, h in bits):
            raise AssertionError(f"binned_calibration[{tag}]: two launches on the same inputs differ")
        cal_routes[tag] = route if route == "atomics" else f"{route}/K={regs}/{'16B' if vec else '4B'}"
    _log(f"binned_calibration: counts exact, sums within 1e-5 relative of plain, two launches bit-identical on every case but the atomics route's; route per case {cal_routes}")
    for tag in ("main_b15", "one_bin", "b64", "n4194304", "b5000"):
        conf, acc, bounds = cal_cases[tag]
        bins = bounds.numel() - 1
        bound_ms, bound_by = _bound_ms(2 * conf.numel() * 4 + (bins + 1) * 4 + bins * 16, conf.numel() * np.log2(bins + 1))
        rec = dict(
            source="metrics_tpu_torch/csrc/binned_counts.cu",
            replaces="metrics_tpu/ops/binned_counts.py:172",
            max_abs_err=max(errs), ms=_cuda_ms(torch, lambda: bc._binned_calibration_cuda(conf, acc, bounds)),
            plain_ms=_cuda_ms(torch, lambda: bc._binned_calibration_plain(conf, acc, bounds)),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None, shape=f"N={conf.numel()}, B={bins}",
        )
        if tag == "main_b15":
            records["binned_calibration"] = rec
        else:
            _log(f"kernel binned_calibration ({tag}, {rec['shape']}): ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.5f} ({bound_by})")
    for name, rec in records.items():
        _log(
            f"kernel {name} ({rec['shape']}): matches plain on all {len(cases) if name == 'binned_counts' else len(cal_cases)} cases"
            f" (max abs err {rec['max_abs_err']:.3g}); ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f}"
            f" library_ms=none (no single call) bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']})"
        )
    conf, acc, b15 = cal_cases["main_b15"]
    one_bin, cal_big = cal_cases["one_bin"], cal_cases["n4194304"]
    ctr_uniform, ctr_skewed = cases["ctr_shape"], cases["ctr_skewed"]
    calls = {
        "binned_counts": lambda: bc._binned_counts_cuda(*main),
        "binned_counts@ctr_uniform": lambda: bc._binned_counts_cuda(*ctr_uniform),
        "binned_counts@ctr_skewed": lambda: bc._binned_counts_cuda(*ctr_skewed),
        "binned_calibration": lambda: bc._binned_calibration_cuda(conf, acc, b15),
        "binned_calibration@one_bin": lambda: bc._binned_calibration_cuda(*one_bin),
        "binned_calibration@n4194304": lambda: bc._binned_calibration_cuda(*cal_big),
    }
    return records, calls


def _unit(torch, a):
    return a / torch.linalg.vector_norm(a, dim=1, keepdim=True)


def _embeddings(rng, n: int, classes: int, d: int = EMB_DIM):
    """Seeded class-clustered embeddings: a shared positive offset (pooled
    features are not centred), a class centre and per-image noise."""
    offset = rng.random(d, dtype=np.float32) * np.float32(0.8)
    centres = rng.standard_normal((classes, d), dtype=np.float32) * np.float32(0.4)
    emb = centres[rng.integers(0, classes, n)]
    emb += offset
    emb += rng.standard_normal((n, d), dtype=np.float32) * np.float32(0.2)
    return emb


def _dml_embeddings(rng):
    """The pairwise path's embeddings, made once for its kernel check and its
    functional calls: SOP's test split, and In-Shop's queries and gallery."""
    return {
        "sop": _embeddings(rng, *SOP_TEST),
        "query": _embeddings(rng, INSHOP[0], INSHOP[2]),
        "gallery": _embeddings(rng, INSHOP[1], INSHOP[2]),
    }


def _pairwise_cases(torch, rng, dev, emb):
    """``name -> (x, y, op, zero_diagonal)`` at the pairwise path's shapes and on edge inputs."""
    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    x, y = normal(1000, 200), normal(777, 200)  # no size a multiple of a tile
    with_nan = x.clone()
    with_nan[5, 3] = float("nan")
    y_nan = y.clone()
    y_nan[7, 0] = float("nan")
    zero_row = x.clone()
    zero_row[9] = 0.0
    wide_x, wide_y = normal(300, 5000), normal(129, 5000)
    query, gallery = (torch.from_numpy(emb[k]).to(dev) for k in ("query", "gallery"))
    sop = _unit(torch, torch.from_numpy(emb["sop"]).to(dev))
    # a NaN column on the masked diagonal: row 2 stays finite, the others are NaN
    diag_x, diag_y = normal(5, 4), normal(6, 4)
    diag_y_zero, diag_y_nan = diag_y.clone(), diag_y.clone()
    diag_y_zero[2] = 0.0
    diag_y_nan[2, 1] = float("nan")
    d5_x, d5_y = normal(301, 5), normal(203, 5)

    def misaligned(a):  # the same values, 4 bytes past an allocation: not 16-byte aligned
        return torch.cat([a.new_zeros(1), a.reshape(-1)])[1:].view(a.shape)

    far_zero = normal(300, 64)
    far_zero[200] = 0.0  # a zero row of y at an index >= N (= 100)
    return {
        "euclidean": (x, y, "euclidean", False),
        "cosine": (_unit(torch, x), _unit(torch, y), "cosine", False),
        "euclidean_self_zero_diag": (x, x, "euclidean", True),
        "cosine_self_zero_diag": (_unit(torch, x), _unit(torch, x), "cosine", True),
        "euclidean_pair_zero_diag": (x, y, "euclidean", True),
        "cosine_pair_zero_diag": (_unit(torch, x), _unit(torch, y), "cosine", True),
        "d1": (x[:, :1].contiguous(), y[:, :1].contiguous(), "euclidean", False),
        "d5000": (wide_x, wide_y, "euclidean", True),
        "d5000_cosine": (_unit(torch, wide_x), _unit(torch, wide_y), "cosine", False),
        "f64": (x.double(), y.double(), "euclidean", False),
        "f64_self_zero_diag": (x.double(), x.double(), "euclidean", True),
        "f64_cosine": (_unit(torch, x.double()), _unit(torch, y.double()), "cosine", True),
        "bf16": (x.bfloat16(), y.bfloat16(), "euclidean", False),
        "bf16_cosine": (_unit(torch, x).bfloat16(), _unit(torch, y).bfloat16(), "cosine", True),
        "f16": (x.half(), y.half(), "euclidean", True),
        "nan_row": (with_nan, y, "euclidean", False),  # that row's sum is NaN, the others are not
        "nan_column": (x, y_nan, "euclidean", False),  # every row's sum is NaN
        "nan_row_cosine": (_unit(torch, with_nan), _unit(torch, y), "cosine", True),
        "zero_row_cosine": (_unit(torch, zero_row), _unit(torch, y), "cosine", False),
        "nan_column_on_masked_diagonal": (diag_x, diag_y_nan, "euclidean", True),
        "nan_column_on_masked_diagonal_cosine": (_unit(torch, diag_x), _unit(torch, diag_y_zero), "cosine", True),
        "tiny_3x2": (x[:3], y[:2], "euclidean", True),
        "tiny_3x2_cosine": (_unit(torch, x[:3]), _unit(torch, y[:2]), "cosine", True),
        "one_by_one": (x[:1], x[:1], "euclidean", True),
        "one_by_one_cosine": (_unit(torch, x[:1]), _unit(torch, x[:1]), "cosine", True),
        "zero_row_self_cosine": (_unit(torch, x[:1] * 0), _unit(torch, x[:1] * 0), "cosine", True),  # gives [0.]
        "m1": (x, y[:1], "euclidean", False),
        "m1_cosine": (_unit(torch, x), _unit(torch, y[:1]), "cosine", True),
        "d5": (d5_x, d5_y, "euclidean", True),
        "d5_cosine": (_unit(torch, d5_x), _unit(torch, d5_y), "cosine", True),
        "d5_offset_view": (d5_x[1:], d5_y, "euclidean", True),
        "misaligned": (misaligned(x[:301, :8]), x[:, :8].contiguous(), "euclidean", True),
        "misaligned_cosine": (misaligned(_unit(torch, x[:301, :8])), _unit(torch, x[:, :8]), "cosine", True),
        "zero_row_of_y_beyond_n": (x[:100, :64], far_zero, "euclidean", True),
        "zero_row_of_y_beyond_n_cosine": (_unit(torch, x[:100, :64]), _unit(torch, far_zero), "cosine", True),
        "inshop": (query, gallery, "euclidean", False),
        "sop": (sop, sop, "cosine", True),
    }


def _pairwise_err(torch, name: str, got, want, op: str, m: int) -> float:
    """Max |kernel - plain| of the row sums; raises unless NaN sits in the
    same rows and the finite rows agree: euclidean within 1e-5 relative
    (1e-12 for float64), cosine within 1e-5 absolute on the row mean (the
    entries lie in [-1, 1]; 1e-12 for float64). bfloat16 and float16 inputs
    are compared before the cast back, in float32."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: kernel gives {got.dtype}{tuple(got.shape)}, plain {want.dtype}{tuple(want.shape)}")
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"{name}: NaN rows differ between kernel and plain version")
    finite = ~torch.isnan(want)
    if not finite.any():
        return 0.0
    diff = (got[finite].double() - want[finite].double()).abs()
    tol = 1e-12 if got.dtype == torch.float64 else 1e-5
    bad = diff > tol * want[finite].double().abs() if op == "euclidean" else diff / m > tol
    if bad.any():
        raise AssertionError(f"{name}: kernel and plain row sums differ (max abs err {diff.max().item()}, tolerance {tol})")
    return diff.max().item()


def _check_pairwise_edges(name: str, got) -> None:
    """The composition's answers on the edge cases, beyond agreeing with the plain version."""
    if name.startswith("nan_column_on_masked_diagonal"):
        nan = got.isnan().tolist()
        if nan != [True, True, False, True, True]:
            raise AssertionError(f"pairwise_reduce[{name}]: NaN rows {nan}, want every row but row 2")
    if name == "zero_row_self_cosine" and got.tolist() != [0.0]:
        raise AssertionError(f"pairwise_reduce[{name}]: {got.tolist()}, want [0.0]")


def check_and_time_pairwise(torch, rng, emb):
    from metrics_tpu_torch.ops import pairwise_reduce as pr

    dev = torch.device("cuda")
    cases = _pairwise_cases(torch, rng, dev, emb)
    errs = {}
    for tag, (x, y, op, zd) in cases.items():
        got = pr._pairwise_cuda(x, y, op, zd)
        errs[tag] = _pairwise_err(torch, f"pairwise_reduce[{tag}]", got, pr._pairwise_plain(x, y, op, zd), op, y.shape[0])
        _check_pairwise_edges(tag, got)
    _log(f"kernel pairwise_reduce: matches plain on all {len(cases)} cases; max abs err of the row sums per case {errs}")
    torch.backends.cuda.matmul.allow_tf32 = False  # the library yardsticks multiply in full float32
    records, calls = {}, {}
    for tag, libraries in (
        ("inshop", {"torch.cdist(x, y).sum(1)": lambda x, y: torch.cdist(x, y).sum(1)}),
        ("sop", {"torch.mm(x, y.T).sum(1)": lambda x, y: torch.mm(x, y.T).sum(1),
                 "torch.mv(x, y.sum(0)), the linear order": lambda x, y: torch.mv(x, y.sum(0))}),
    ):
        x, y, op, zd = cases[tag]
        (n, d), m = x.shape, y.shape[0]
        first, second = pr._pairwise_cuda(x, y, op, zd), pr._pairwise_cuda(x, y, op, zd)
        if not torch.equal(first, second):
            raise AssertionError(f"pairwise_reduce[{tag}]: two launches give different row sums")
        iters = 10
        in_bytes = (n if x.data_ptr() == y.data_ptr() else n + m) * d * x.element_size()
        if op == "cosine":
            # the row sums are linear, x_i.(sum_j y_j) (less x_i.y_i with the
            # diagonal zeroed), so the function needs O((N + M) d) operations
            bound_ms, bound_by = _bound_ms(in_bytes + n * 4, (m + (2 if zd else 1) * n) * d)
        else:
            bound_ms, bound_by = _bound_ms(in_bytes + n * 4, 2 * n * m * d, TF32_FLOPS_PER_S)
        lib_ms = {name: _cuda_ms(torch, lambda fn=fn: fn(x, y), iters=iters, warmup=1) for name, fn in libraries.items()}
        rec = dict(
            source="metrics_tpu_torch/csrc/pairwise_reduce.cu",
            replaces="metrics_tpu/ops/pairwise_reduce.py:39",
            max_abs_err=max(errs.values()),
            ms=_cuda_ms(torch, lambda: pr._pairwise_cuda(x, y, op, zd), iters=iters, warmup=1),
            plain_ms=_cuda_ms(torch, lambda: pr._pairwise_plain(x, y, op, zd), iters=iters, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=next(iter(lib_ms.values())),
            shape=f"{op} [{n}, {d}] x [{m}, {d}] f32{', zero diagonal' if zd else ''}",
        )
        context = (
            f"3-pass split-TF32 floor of this design {3 * bound_ms:.4f} ms" if op == "euclidean"
            else f"N*M*d FMA floor of a design that forms every cell on the CUDA cores {n * m * d / CUDA_CORE_OPS_PER_S * 1e3:.4f} ms"
        )
        _log(
            f"kernel pairwise_reduce ({rec['shape']}): ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f}"
            f" bound_ms={rec['bound_ms']:.4f} ({bound_by}), {100 * rec['bound_ms'] / rec['ms']:.1f}% of the bound;"
            f" {'; '.join(f'{k} {v:.4f} ms' for k, v in lib_ms.items())} (allow_tf32=False); {context};"
            f" two launches bit-identical"
        )
        if tag == "inshop":
            records["pairwise_reduce"] = rec
            calls["pairwise_reduce"] = lambda x=x, y=y: pr._pairwise_cuda(x, y, "euclidean", False)
    del cases
    torch.cuda.empty_cache()
    return records, calls


def _imagenet_stream(rng, n: int = IMAGENET_VAL[0]):
    """Seeded ImageNet-1k logits with a signal on the target class (val size by default)."""
    c = IMAGENET_VAL[1]
    target = rng.integers(0, c, n)
    logits = rng.standard_normal((n, c), dtype=np.float32)
    logits[np.arange(n), target] += np.float32(3.0)
    return logits, target


def _numpy_oracle(logits: np.ndarray, target: np.ndarray, c: int):
    n = len(target)
    rows = np.arange(n)
    t_score = logits[rows, target][:, None]
    cols = np.arange(c)[None, :]
    rank = (logits > t_score).sum(1) + ((logits == t_score) & (cols < target[:, None])).sum(1)
    pred1 = logits.argmax(1)
    confmat = np.zeros((c, c), np.int64)
    np.add.at(confmat, (target, pred1), 1)
    tp = np.diag(confmat).astype(np.float64)
    fp = confmat.sum(0) - tp
    fn = confmat.sum(1) - tp
    precision = np.divide(tp, tp + fp, out=np.zeros(c), where=(tp + fp) > 0)
    recall = np.divide(tp, tp + fn, out=np.zeros(c), where=(tp + fn) > 0)
    f1 = np.divide(2 * precision * recall, precision + recall, out=np.zeros(c), where=(precision + recall) > 0)
    present = (tp + fp + fn) > 0
    return {
        "top1": (pred1 == target).mean(),
        "top5": (rank < TOP_K).mean(),
        "f1": f1[present].mean(),
        "confmat": confmat,
    }


def _check_result(name: str, got, want) -> None:
    got = got.cpu().numpy()
    if np.asarray(want).dtype.kind in "iu":
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: counts differ from the numpy oracle")
    elif not np.isfinite(got).all() or abs(float(got) - float(want)) > 1e-6 * abs(float(want)):
        raise AssertionError(f"{name}: {float(got)!r} vs numpy oracle {float(want)!r} (rtol 1e-6)")


def _batches_of(total: int, batch: int):
    return [(s, min(s + batch, total)) for s in range(0, total, batch)]


def _batches(total: int):
    return _batches_of(total, BATCH)


def _imagenet_collection(mt):
    c = IMAGENET_VAL[1]
    return mt.MetricCollection(
        {
            "top1": mt.Accuracy(num_classes=c),
            "top5": mt.Accuracy(num_classes=c, top_k=TOP_K),
            "f1": mt.F1Score(num_classes=c, average="macro"),
            "confmat": mt.ConfusionMatrix(num_classes=c),
        }
    )


def run_main_path(torch, mt, rng):
    n, c = IMAGENET_VAL
    logits_np, target_np = _imagenet_stream(rng)
    oracle = _numpy_oracle(logits_np, target_np, c)
    logits = torch.from_numpy(logits_np).cuda()
    target = torch.from_numpy(target_np).cuda()
    mc = _imagenet_collection(mt)
    batches = _batches(n)
    torch.cuda.synchronize()
    mt.reset_kernel_stats()
    t0 = time.perf_counter()
    for s, e in batches:
        mc(logits[s:e], target[s:e])
    result = mc.compute()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stats = mt.kernel_stats()
    for key, want in oracle.items():
        _check_result(f"imagenet {key}", result[key], want)
    for op in ("confusion_counts", "select_topk"):
        if stats[op]["launches"] != len(batches):
            raise AssertionError(f"{op}: {stats[op]['launches']} launches for {len(batches)} batches")
    if any(rec["plain_calls"] for rec in stats.values()):
        raise AssertionError(f"a plain version ran on the main path: {stats}")
    updates = {k: m._update_count for k, m in mc.items()}
    _require_programs("main path", mc, forward=True, captured=True)
    _log(
        f"main path: ImageNet-1k val, {n} samples x {c} classes in {len(batches)} batches: matches the numpy oracle"
        f" (top1={float(result['top1']):.6f} top5={float(result['top5']):.6f} macro_f1={float(result['f1']):.6f});"
        f" {n / seconds:.0f} samples/s ({seconds * 1e3 / len(batches):.2f} ms/batch, first batch and its capture included);"
        f" updates per metric {updates}; {_engine_note(mc)}; kernel_stats {stats}"
    )
    return stats, mc, logits, target, (logits_np, target_np, oracle)


def run_multilabel(torch, mt, rng):
    n, c = COCO_VAL
    probs_np = rng.random((n, c), dtype=np.float32)
    target_np = (rng.random((n, c)) < 0.05).astype(np.int64)  # about 3 labels per COCO image
    p_np = (probs_np >= 0.5).astype(np.int64)
    oracle = np.stack(
        [
            ((1 - p_np) * (1 - target_np)).sum(0),
            (p_np * (1 - target_np)).sum(0),
            ((1 - p_np) * target_np).sum(0),
            (p_np * target_np).sum(0),
        ],
        axis=-1,
    ).reshape(c, 2, 2)
    probs, target = torch.from_numpy(probs_np).cuda(), torch.from_numpy(target_np).cuda()
    cm = mt.ConfusionMatrix(num_classes=c, multilabel=True)
    batches = _batches(n)
    torch.cuda.synchronize()
    mt.reset_kernel_stats()
    for s, e in batches:
        cm(probs[s:e], target[s:e])
    result = cm.compute()
    stats = mt.kernel_stats()
    _check_result("coco multilabel confmat", result, oracle)
    if stats["multilabel_counts"]["launches"] != len(batches) or any(r["plain_calls"] for r in stats.values()):
        raise AssertionError(f"multilabel path: {stats} for {len(batches)} batches")
    _require_programs("coco multilabel confusion", cm)
    _log(
        f"multilabel: MS-COCO 2014 val, {n} samples x {c} labels in {len(batches)} batches: matches the numpy oracle;"
        f" {_engine_note(cm)}; kernel_stats {stats}"
    )
    return stats, (cm, probs, target)


def _same_values(name: str, got: dict, want: dict) -> None:
    """Every value of ``want`` in ``got``, on the card, equal bit for bit."""
    for key, w in want.items():
        g = got[key]
        if g.device.type != "cuda" or g.shape != w.shape or g.dtype != w.dtype or not bool((g == w).all()):
            raise AssertionError(f"{name} {key}: {g} on {g.device}, want {w}")


def run_copy_phase(torch, mt, rng, logits, target):
    """Copies on the card, mid-stream: ``clone()`` of the ImageNet-1k
    collection, fed the rest of the stream beside the original (their
    results must be equal and both take the kernels), and a pickle round
    trip of a CUDA multilabel ``ConfusionMatrix`` over MS-COCO 2014 val,
    whose copy must stay on ``cuda`` and launch ``multilabel_counts``."""
    import pickle

    batches = _batches(IMAGENET_VAL[0])
    half = len(batches) // 2
    mc = _imagenet_collection(mt)
    t0 = _reset_stats(torch, mt)
    for s, e in batches[:half]:
        mc(logits[s:e], target[s:e])
    twin = mc.clone(prefix="twin_")
    for s, e in batches[half:]:
        mc(logits[s:e], target[s:e])
        twin(logits[s:e], target[s:e])
    launches = half + 2 * (len(batches) - half)
    _, stats = _read_stats(torch, mt, t0, {"confusion_counts": launches, "select_topk": launches})
    want = mc.compute()
    got = {k[len("twin_"):]: v for k, v in twin.compute().items()}
    _same_values("clone of the imagenet collection", got, want)

    n, c = COCO_VAL
    probs = torch.from_numpy(rng.random((n, c), dtype=np.float32)).cuda()
    labels = torch.from_numpy((rng.random((n, c)) < 0.05).astype(np.int64)).cuda()
    coco = _batches(n)
    cm = mt.ConfusionMatrix(num_classes=c, multilabel=True)
    for s, e in coco[:2]:
        cm(probs[s:e], labels[s:e])
    restored = pickle.loads(pickle.dumps(cm))
    if restored.device.type != "cuda" or restored.confmat.device.type != "cuda":
        raise AssertionError(f"pickled multilabel ConfusionMatrix came back on {restored.device} / {restored.confmat.device}")
    t0 = _reset_stats(torch, mt)
    for s, e in coco[2:]:
        restored(probs[s:e], labels[s:e])
    _, copy_stats = _read_stats(torch, mt, t0, {"multilabel_counts": len(coco) - 2})
    for s, e in coco[2:]:
        cm(probs[s:e], labels[s:e])
    _same_values("pickled multilabel confusion matrix", {"confmat": restored.compute()}, {"confmat": cm.compute()})
    _log(
        f"copy phase: the imagenet collection cloned after {half} of {len(batches)} batches gives the original's values"
        f" (top1={float(want['top1']):.6f}; kernel_stats {stats}); a multilabel ConfusionMatrix pickled after 2 of"
        f" {len(coco)} batches stays on cuda and matches the original after the rest (its updates: kernel_stats {copy_stats})"
    )


# ---------------------------------------------------------------------------
# the engine phase: the ImageNet-1k collection six ways, capture checks, health
# ---------------------------------------------------------------------------
ENGINE_PATTERN = (8192, 5000, 3000, 848)  # the ragged stream of mode (d), repeated over the 50,000
ENGINE_CHUNK = 2  # steps per program replay in mode (f)
ENGINE_WARM_PASSES = 5  # timed passes after the first; the median is logged
HEALTH_BAD_ROWS = {1: 3, 4: 5}  # batch -> rows of it made NaN in the health checks


def _program_counts(obj):
    """``(captures, cache hits, members that ran eagerly)`` of a metric or
    collection, its fused programs and its members' own together."""
    stats = obj.compile_stats()
    members = stats.get("members", {"": stats})
    eager = sorted(k for k, s in members.items() if s["jit_failed"] or not s["jit_enabled"])
    if "members" not in stats:
        return stats["compiles"], stats["cache_hits"], eager
    return tuple(stats[k] + sum(s[k] for s in members.values()) for k in ("compiles", "cache_hits")) + (eager,)


def _engine_note(obj) -> str:
    """How an object's updates ran: through programs (CUDA graphs) or eagerly."""
    captures, hits, eager = _program_counts(obj)
    return f"programs: {captures} captured, {hits} cache hits, eager members {eager}"


def _require_programs(name: str, obj, forward: bool = False, captured: bool = False) -> None:
    """Every member ran through programs: none fell back, and later batches
    replayed one (cache hits); with ``captured``, this object captured at
    least one itself (another instance of the same configuration may have
    captured the programs a later phase replays)."""
    captures, hits, eager = _program_counts(obj)
    fused_failed = getattr(obj, "_fused_fwd_failed" if forward else "_fused_failed", False)
    if eager or fused_failed or hits < 1 or (captured and captures < 1):
        raise AssertionError(f"{name}: not captured as programs: {obj.compile_stats()} (fused failed: {fused_failed})")


def _ragged_bounds(total: int):
    out, s, i = [], 0, 0
    while s < total:
        e = min(s + ENGINE_PATTERN[i % len(ENGINE_PATTERN)], total)
        out.append((s, e))
        s, i = e, i + 1
    return out


def _engine_modes(torch, mt, logits, target, logits_cpu, target_cpu):
    """label -> (collection kwargs, run(mc) -> results, batches, warm launches
    per kernel, extra launches of the first pass). Every mode streams all of
    ImageNet-1k val and computes."""
    from metrics_tpu_torch.engine import drive
    from metrics_tpu_torch.utils.program import program_scope

    n = IMAGENET_VAL[0]
    full, ragged = _batches(n), _ragged_bounds(n)
    whole = (len(full) - 1) * BATCH  # the stacked epoch of mode (e); the 848 tail goes first

    def stream(bounds):
        def run(mc):
            for s, e in bounds:
                mc.update(logits[s:e], target[s:e])
            return mc.compute()

        return run

    def unchecked(mc):
        with program_scope(guard=False):
            return stream(full)(mc)

    def stacked(mc):
        mc.update(logits[whole:], target[whole:])
        steps = len(full) - 1
        res = drive(mc, (logits[:whole].view(steps, BATCH, -1), target[:whole].view(steps, BATCH)), compute_in_trace=True)
        return res.values

    def host_iterable(mc):
        res = drive(mc, ((logits_cpu[s:e], target_cpu[s:e]) for s, e in full), compute_in_trace=True, steps_per_chunk=ENGINE_CHUNK)
        return res.values

    chunked = -(-len(full) // ENGINE_CHUNK) * ENGINE_CHUNK
    return {
        "(a) eager, value checks on": ({"jit_update": False}, stream(full), len(full), len(full), 0),
        "(b) eager, value checks skipped": ({"jit_update": False}, unchecked, len(full), len(full), 0),
        "(c) captured fused update": ({}, stream(full), len(full), len(full), 0),
        "(d) captured, jit_bucket=pow2, ragged stream": ({"jit_bucket": "pow2"}, stream(ragged), len(ragged), len(ragged), 1),
        "(e) drive, stacked epoch, compute_in_trace": ({}, stacked, len(full), len(full), 0),
        "(f) drive, host iterable of CPU batches": ({}, host_iterable, len(full), chunked, 1),
    }


def _device_ms(torch, fn) -> float:
    """Device time of ``fn`` (torch.profiler, every device event summed)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(r["device_us"] for r in _device_rows(prof)) / 1e3


def _host_syncs(torch, fn) -> int:
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _imagenet_collection_with(mt, **kw):
    c = IMAGENET_VAL[1]
    return mt.MetricCollection(
        {
            "top1": mt.Accuracy(num_classes=c, **kw),
            "top5": mt.Accuracy(num_classes=c, top_k=TOP_K, **kw),
            "f1": mt.F1Score(num_classes=c, average="macro", **kw),
            "confmat": mt.ConfusionMatrix(num_classes=c, **kw),
        }
    )


def _time_input_copy(torch, logits) -> float:
    """ms of the copy into a program's static input: one [8192, 1000] float32 batch (32 MB)."""
    src = logits[:BATCH]
    static = torch.empty_like(src)
    return _cuda_ms(torch, lambda: static.copy_(src))


def run_engine_phase(torch, mt, smi: str, logits, target, host_stream):
    """The ImageNet-1k val collection through the engine at full size, six
    ways, each against the numpy oracle and, counts bit for bit, against
    mode (a); then the capture checks and the health policies. Returns the
    launches of the warm passes, by kernel."""
    from metrics_tpu_torch import engine

    logits_np, target_np, oracle = host_stream
    logits_cpu, target_cpu = torch.from_numpy(logits_np), torch.from_numpy(target_np)
    copy_ms = _time_input_copy(torch, logits)
    _log(f"engine: the copy of one batch into a program's static input ([8192, 1000] float32, 32 MB): {copy_ms:.4f} ms; {smi}")
    reference = None
    launches = {"select_topk": 0, "confusion_counts": 0}
    for label, (kw, run, n_batches, warm_launches, extra) in _engine_modes(torch, mt, logits, target, logits_cpu, target_cpu).items():
        mc = _imagenet_collection_with(mt, **kw)
        expect = {"select_topk": warm_launches, "confusion_counts": warm_launches}
        t0 = _reset_stats(torch, mt)
        first = run(mc)
        cold_s, cold_stats = _read_stats(torch, mt, t0, {op: v + extra for op, v in expect.items()})
        if kw.get("jit_bucket") == "pow2":
            buckets = {engine.next_pow2(e - s) for s, e in _ragged_bounds(IMAGENET_VAL[0])}
            if mc.compile_stats()["compiles"] != len(buckets) + 1:  # a fused update per bucket, one fused compute
                raise AssertionError(f"engine {label}: {mc.compile_stats()} for the buckets {sorted(buckets)}")
        mem_mib = torch.cuda.memory_allocated() / 2**20
        static_mib = engine.cache_summary()["static_bytes"] / 2**20
        cold_programs = _engine_note(mc)
        warm = []
        for _ in range(ENGINE_WARM_PASSES):
            mc.reset()
            t0 = _reset_stats(torch, mt)
            result = run(mc)
            seconds, warm_stats = _read_stats(torch, mt, t0, expect)
            warm.append(seconds)
        warm_s = sorted(warm)[len(warm) // 2]
        for op in launches:
            launches[op] += warm_stats[op]["launches"]
        for key, want in oracle.items():
            _check_result(f"engine {label} {key}", result[key], want)
            _check_result(f"engine {label} {key} (first pass)", first[key], want)
        if reference is None:
            reference = result
        elif not torch.equal(result["confmat"], reference["confmat"]):
            raise AssertionError(f"engine {label}: confusion counts differ from mode (a)")
        mc.reset()
        device_ms = _device_ms(torch, lambda: run(mc))
        mc.reset()
        syncs = _host_syncs(torch, lambda: run(mc))
        if kw.get("jit_update", True):
            _require_programs(f"engine {label}", mc, captured=True)
        _log(
            f"engine {label}: {n_batches} batches, {warm_s * 1e3 / n_batches:.3f} ms/batch warm (median of {ENGINE_WARM_PASSES} passes)"
            f" ({cold_s * 1e3 / n_batches:.3f} first pass, captures included), device {device_ms / n_batches:.3f} ms/batch,"
            f" {syncs / n_batches:.2f} host syncs/batch; first pass {cold_programs}; both passes {_engine_note(mc)};"
            f" memory in use after the first pass {mem_mib:.0f} MiB (static program inputs {static_mib:.0f} MiB);"
            f" launches warm {({op: r['launches'] for op, r in warm_stats.items()})}, first pass"
            f" {({op: r['launches'] for op, r in cold_stats.items()})}; matches the numpy oracle"
        )
    # compute_async: one coalesced copy for the collection
    engine.reset_fetch_stats()
    handle = mc.compute_async()
    fetched = handle.result()
    fetches = engine.fetch_stats()
    blocking = mc.compute()
    for key in blocking:
        if not torch.equal(fetched[key], blocking[key].cpu()):
            raise AssertionError(f"compute_async {key}: differs from compute()")
    if fetches["async_fetches"] != 1:
        raise AssertionError(f"compute_async: {fetches}")
    _log(f"engine compute_async: {fetches['async_fetches']} fetch for {fetches['coalesced_leaves']} results, bitwise equal to compute()")
    _run_capture_checks(torch, mt)
    _run_health_checks(torch, mt, logits, target, logits_np, target_np)
    return launches


def _run_capture_checks(torch, mt):
    """binned_calibration captured at 4,194,304 confidences (the cooperative
    grid) against its eager twin, bit for bit (the kernel's fold is fixed)."""
    n = CTR_EVAL[0]
    rng = np.random.default_rng(SEED + 1)
    conf = torch.from_numpy(rng.random(n, dtype=np.float32)).cuda()
    hit = torch.from_numpy((rng.random(n) < conf.cpu().numpy()).astype(np.int64)).cuda()
    graph = mt.CalibrationError(n_bins=CAL_BINS, streaming_bins=True)
    eager = mt.CalibrationError(n_bins=CAL_BINS, streaming_bins=True, jit_update=False)
    t0 = _reset_stats(torch, mt)
    for _ in range(3):
        graph.update(conf, hit)
        eager.update(conf, hit)
    _read_stats(torch, mt, t0, {"binned_calibration": 6})
    for name in graph._defaults:
        if not torch.equal(getattr(graph, name), getattr(eager, name)):
            raise AssertionError(f"captured calibration at N={n}: {name} differs from the eager update")
    _require_programs(f"calibration at N={n}", graph)
    _log(f"engine capture check: CalibrationError(streaming_bins=True) at N={n} (cooperative grid) captured and replayed, bit-identical to eager; {_engine_note(graph)}")


def _run_health_checks(torch, mt, logits, target, logits_np, target_np):
    """on_bad_input="mask" macro F1 and on_bad_input="skip" MeanMetric on the
    ImageNet-1k stream with NaN rows, against the oracle without them."""
    n, c = IMAGENET_VAL
    batches = _batches(n)
    bad = np.zeros(n, bool)
    for b, rows in HEALTH_BAD_ROWS.items():
        bad[batches[b][0]:batches[b][0] + rows] = True
    noisy = logits.clone()
    noisy[torch.from_numpy(np.flatnonzero(bad)).cuda(), 0] = float("nan")
    lse = torch.logsumexp(logits, dim=1)
    loss = (lse - logits.gather(1, target[:, None])[:, 0]).float()
    loss_noisy = torch.where(torch.from_numpy(bad).cuda(), torch.full_like(loss, float("nan")), loss)
    f1 = mt.F1Score(num_classes=c, average="macro", on_bad_input="mask")
    mean = mt.MeanMetric(on_bad_input="skip")
    t0 = _reset_stats(torch, mt)
    for s, e in batches:
        f1.update(noisy[s:e], target[s:e])
        mean.update(loss_noisy[s:e])
    _read_stats(torch, mt, t0, {})  # macro F1 at top-1 takes argmax: no kernel
    kept = ~bad
    want_f1 = _numpy_oracle(logits_np[kept], target_np[kept], c)["f1"]
    _check_result("health mask macro F1", f1.compute(), want_f1)
    clean_batches = [(s, e) for i, (s, e) in enumerate(batches) if i not in HEALTH_BAD_ROWS]
    loss_np = loss.cpu().numpy().astype(np.float64)
    want_mean = np.concatenate([loss_np[s:e] for s, e in clean_batches]).mean()
    _close("health skip mean loss", mean.compute(), want_mean, rtol=1e-5)
    n_bad = int(bad.sum())
    f1_rep, mean_rep = f1.health_report(), mean.health_report()
    if (f1_rep["rows_masked"], f1_rep["nan_count"], f1_rep["updates_quarantined"], f1_rep["batches_screened"]) != (n_bad, n_bad, 0, len(batches)):
        raise AssertionError(f"health mask report {f1_rep}")
    if (mean_rep["updates_quarantined"], mean_rep["nan_count"], mean_rep["rows_masked"]) != (len(HEALTH_BAD_ROWS), n_bad, 0):
        raise AssertionError(f"health skip report {mean_rep}")
    _require_programs("health mask F1", f1)
    _require_programs("health skip MeanMetric", mean)
    _log(
        f"engine health: {n_bad} NaN rows in batches {sorted(HEALTH_BAD_ROWS)}; mask macro F1 {float(f1.compute()):.6f} and skip"
        f" mean loss {float(mean.compute()):.6f} match the oracle without them; reports exact"
        f" (F1 rows_masked={f1_rep['rows_masked']} nan_count={f1_rep['nan_count']};"
        f" mean updates_quarantined={mean_rep['updates_quarantined']} nan_count={mean_rep['nan_count']});"
        f" {_engine_note(f1)}; {_engine_note(mean)}"
    )


# ---------------------------------------------------------------------------
# the sync phase: two ranks on the one card (gloo), and NCCL at world size 1
# ---------------------------------------------------------------------------
SYNC_SEED = 1
SYNC_WORLD = 2
SYNC_RANK_TIMEOUT_S = 420
SYNC_REPEATS = 5
# the sync phase's results by kind: counts and the cat buffer bit for bit,
# scores within 1e-6 relative, float sums within 1e-5 relative
SYNC_EXACT = ("confmat", "confidence")
SYNC_SUMS = ("loss_mean", "loss_max")


def _sync_stream(torch):
    """The ImageNet-1k val stream on the card, from the sync phase's own seed
    (so every rank builds the same one), with each sample's cross-entropy and
    top-1 confidence, computed once over the whole stream."""
    logits_np, target_np = _imagenet_stream(np.random.default_rng(SYNC_SEED))
    logits, target = torch.from_numpy(logits_np).cuda(), torch.from_numpy(target_np).cuda()
    lse = torch.logsumexp(logits, dim=1)
    loss = lse - logits.gather(1, target[:, None])[:, 0]
    confidence = torch.exp(logits.max(dim=1).values - lse)
    return {"preds": logits, "target": target, "loss": loss, "confidence": confidence}


def _sync_collection(mt):
    """The ImageNet collection of the main path, and the rest of the
    classification metrics, the aggregators over each sample's loss and
    confidence, and the harmonic mean of precision and recall built by the
    operators (from operands of its own, so that no update counts twice)."""
    c = IMAGENET_VAL[1]

    class LossMean(mt.MeanMetric):
        def update(self, loss):
            super().update(loss)

    class LossMax(mt.MaxMetric):
        def update(self, loss):
            super().update(loss)

    class Confidence(mt.CatMetric):
        def update(self, confidence):
            super().update(confidence)

    precision = mt.Precision(num_classes=c, average="macro", top_k=TOP_K)
    recall = mt.Recall(average="micro")
    return mt.MetricCollection(
        {
            "top1": mt.Accuracy(num_classes=c),
            "top5": mt.Accuracy(num_classes=c, top_k=TOP_K),
            "f1": mt.F1Score(num_classes=c, average="macro"),
            "confmat": mt.ConfusionMatrix(num_classes=c),
            "precision": mt.Precision(num_classes=c, average="macro", top_k=TOP_K),
            "recall": mt.Recall(average="micro"),
            "specificity": mt.Specificity(num_classes=c, average="macro"),
            "hamming": mt.HammingDistance(),
            "loss_mean": LossMean(),
            "loss_max": LossMax(),
            "confidence": Confidence(),
            "harmonic": 2 / (1 / precision + 1 / recall),
        }
    )


def _sync_batches(rank: int):
    """The batches a rank streams: rank 0 the even ones (the ragged 848 last), rank 1 the odd ones."""
    return _batches(IMAGENET_VAL[0])[rank::SYNC_WORLD]


def _stream_into(mc, data, bounds) -> None:
    for s, e in bounds:
        mc(**{k: v[s:e] for k, v in data.items()})


def _set_sync(torch, mt, mc, on: bool) -> None:
    """Every metric in the collection, operands included: forget the cached
    value, and sync (the default) or compute on the local state."""
    for m in mc.modules():
        if isinstance(m, mt.Metric):
            m._computed = None
            m._distributed_available_fn = None if on else (lambda: False)


def _timed_computes(torch, mt, mc, on: bool):
    """``SYNC_REPEATS`` computes of the collection, with or without the sync:
    the first result, each time in ms, and the collectives per compute."""
    import torch.distributed as dist

    calls = {"n": 0}
    all_gather = dist.all_gather

    def counted(*args, **kwargs):
        calls["n"] += 1
        return all_gather(*args, **kwargs)

    dist.all_gather = counted
    try:
        times, result = [], None
        for _ in range(SYNC_REPEATS):
            _set_sync(torch, mt, mc, on)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            value = mc.compute()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            result = value if result is None else result
    finally:
        dist.all_gather = all_gather
        _set_sync(torch, mt, mc, True)
    return result, times, calls["n"] / SYNC_REPEATS


def _sync_rank(rank: int, port: int, out_path: str) -> None:
    """One rank of the sync phase (this script run with ``--sync-rank``):
    join the gloo group, stream this rank's batches on ``cuda:0``, and save
    the synced results, the local compute's, the launches and the times."""
    import torch
    import torch.distributed as dist
    from datetime import timedelta

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import metrics_tpu_torch as mt

    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=SYNC_WORLD, rank=rank, timeout=timedelta(seconds=120)
    )
    try:
        data = _sync_stream(torch)
        mc = _sync_collection(mt)
        bounds = _sync_batches(rank)
        t0 = _reset_stats(torch, mt)
        _stream_into(mc, data, bounds)
        seconds, stats = _read_stats(torch, mt, t0, {"select_topk": 3 * len(bounds), "confusion_counts": len(bounds)})
        from metrics_tpu_torch.parallel import comm

        gathers = {"n": 0}
        gather = comm.gather_all_arrays

        def counted_gather(*args, **kwargs):
            gathers["n"] += 1
            return gather(*args, **kwargs)

        comm.gather_all_arrays = counted_gather
        try:
            synced, sync_ms, collectives = _timed_computes(torch, mt, mc, on=True)
        finally:
            comm.gather_all_arrays = gather
        local, local_ms, local_collectives = _timed_computes(torch, mt, mc, on=False)
        reports = {
            name: (type(m).__name__, m.sync_report())
            for name, m in mc.named_modules()
            if isinstance(m, mt.Metric)
        }
        if local_collectives:
            raise AssertionError(f"rank {rank}: the local compute ran {local_collectives} collectives")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(
        {
            "synced": {k: v.cpu() for k, v in synced.items()},
            "rows": int(local["confidence"].numel()),
            "devices": sorted({v.device.type for v in synced.values()}),
            "launches": {op: stats[op]["launches"] for op in ("select_topk", "confusion_counts")},
            "stream_s": seconds,
            "sync_ms": sync_ms,
            "local_ms": local_ms,
            "collectives": collectives,
            "gathers": gathers["n"],
            "reports": reports,
        },
        out_path,
    )


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(out_dir: str):
    """Start the two ranks, wait for each within its limit, and return their
    records; a rank that fails or outlives its limit raises, with the logs."""
    port = _free_port()
    procs = []
    for rank in range(SYNC_WORLD):
        log = open(os.path.join(out_dir, f"rank{rank}.log"), "w+")
        cmd = [sys.executable, os.path.abspath(__file__), "--sync-rank", str(rank), str(port), os.path.join(out_dir, f"rank{rank}.pt")]
        procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log))
    failed = []
    try:
        deadline = time.monotonic() + SYNC_RANK_TIMEOUT_S
        for rank, (proc, _) in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = f"killed after {SYNC_RANK_TIMEOUT_S} s"
            if rc != 0:
                failed.append((rank, rc))
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    logs = []
    for rank, (_, log) in enumerate(procs):
        log.seek(0)
        logs.append(log.read())
        log.close()
    if failed:
        tails = "\n".join(f"--- rank {r} ---\n{text[-6000:]}" for r, text in enumerate(logs))
        raise AssertionError(f"sync phase: ranks failed {failed}\n{tails}")
    import torch

    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(SYNC_WORLD)]


def _same_as(name: str, got: dict, want: dict, exact: bool = False) -> None:
    """``got`` equals ``want``: counts and the cat buffer (everything, with
    ``exact``) bit for bit, scores within 1e-6 relative and float sums within
    1e-5 relative."""
    if set(got) != set(want):
        raise AssertionError(f"{name}: keys {sorted(got)} vs {sorted(want)}")
    for key, w in want.items():
        g, w = got[key].cpu(), w.cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name} {key}: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        if exact or key in SYNC_EXACT or not g.is_floating_point():
            if not bool((g == w).all()):
                raise AssertionError(f"{name} {key}: differs (bit for bit)")
            continue
        rtol = 1e-5 if key in SYNC_SUMS else 1e-6
        if not bool(g.isfinite().all()) or not bool(((g.double() - w.double()).abs() <= rtol * w.double().abs()).all()):
            raise AssertionError(f"{name} {key}: {g.tolist()} vs {w.tolist()} (rtol {rtol})")


def _check_sync_reports(rank: int, rec: dict, other: dict) -> str:
    """Each metric's ``sync_report()`` on one rank against the syncs and
    gathers that rank made: ``syncs`` one per synced ``compute()`` (none
    for an operator's composition, whose operands sync), ``attempts`` the
    ``gather_all_arrays`` calls in all, ``bytes_received`` the other
    rank's ``bytes_sent``, and the last outcome ``complete``."""
    attempts = sent = 0
    for name, (cls, report) in rec["reports"].items():
        composed = cls == "CompositionalMetric"
        want_syncs = 0 if composed else SYNC_REPEATS
        if report["syncs"] != want_syncs or report["last_sync_outcome"] != (None if composed else "complete"):
            raise AssertionError(f"sync phase rank {rank} {name}: sync_report {report}, {want_syncs} syncs made")
        if report["bytes_received"] != other["reports"][name][1]["bytes_sent"]:
            raise AssertionError(
                f"sync phase rank {rank} {name}: received {report['bytes_received']} bytes, the other rank sent"
                f" {other['reports'][name][1]['bytes_sent']}"
            )
        if report["degraded_local"] or (not composed and report["bytes_sent"] <= 0):
            raise AssertionError(f"sync phase rank {rank} {name}: sync_report {report}")
        attempts += report["attempts"]
        sent += report["bytes_sent"]
    if attempts != rec["gathers"]:
        raise AssertionError(f"sync phase rank {rank}: sync_report attempts {attempts}, gathers made {rec['gathers']}")
    return f"{len(rec['reports'])} metrics, {attempts} attempts = gathers made, {sent} bytes sent, received as the other rank sent"


def run_sync_phase(torch, mt, smi: str):
    """The cross-process sync at full width. (a) Two ranks on the one card
    join a gloo group over TCP loopback, each with its metrics on ``cuda:0``;
    rank 0 streams batches 0, 2, 4 and 6, rank 1 batches 1, 3 and 5, and
    each ``compute()`` syncs. Both ranks must equal each other and one
    process's result over the whole stream in rank-major order. (b) That
    process then joins an NCCL group of one, and its ``compute()`` through
    NCCL must equal its unsynced result. Returns the launches of the phase."""
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as out_dir:
        ranks = _run_ranks(out_dir)
    for rank, rec in enumerate(ranks):
        if rec["devices"] != ["cuda"] or min(rec["launches"].values()) <= 0:
            raise AssertionError(f"sync phase rank {rank}: results on {rec['devices']}, launches {rec['launches']}")
    _same_as("sync phase: rank 1 against rank 0", ranks[1]["synced"], ranks[0]["synced"], exact=True)
    report_notes = [_check_sync_reports(rank, rec, ranks[1 - rank]) for rank, rec in enumerate(ranks)]

    data = _sync_stream(torch)
    mc = _sync_collection(mt)
    order = [b for rank in range(SYNC_WORLD) for b in _sync_batches(rank)]
    t0 = _reset_stats(torch, mt)
    _stream_into(mc, data, order)
    _, serial_stats = _read_stats(torch, mt, t0, {"select_topk": 3 * len(order), "confusion_counts": len(order)})
    serial, serial_ms, _ = _timed_computes(torch, mt, mc, on=False)
    for rank, rec in enumerate(ranks):
        _same_as(f"sync phase: rank {rank} against one process over the whole stream", rec["synced"], serial)
        if rec["rows"] != sum(e - s for s, e in _sync_batches(rank)):
            raise AssertionError(f"sync phase rank {rank}: unsync left {rec['rows']} buffered confidences")

    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0, device_id=torch.device("cuda:0")
    )
    try:
        nccl, nccl_ms, nccl_collectives = _timed_computes(torch, mt, mc, on=True)
    finally:
        dist.destroy_process_group()
    _same_as("sync phase: NCCL at world size 1 against the unsynced result", nccl, serial, exact=True)

    def ms(times):
        return f"first {times[0]:.2f} ms, median {sorted(times)[len(times) // 2]:.2f} ms"

    for rank, rec in enumerate(ranks):
        _log(
            f"sync phase rank {rank} (gloo, {SYNC_WORLD} ranks on cuda:0, {len(_sync_batches(rank))} batches in"
            f" {rec['stream_s']:.2f} s): compute() with the sync {ms(rec['sync_ms'])}, without {ms(rec['local_ms'])};"
            f" {rec['collectives']:.0f} collectives per synced compute(); launches {rec['launches']};"
            f" sync_report {report_notes[rank]}; {smi}"
        )
    _log(
        f"sync phase NCCL world size 1: compute() with the sync {ms(nccl_ms)}, without {ms(serial_ms)};"
        f" {nccl_collectives:.0f} collectives per synced compute(); {smi}"
    )
    _log(
        f"sync phase: both ranks equal each other and one process over all {IMAGENET_VAL[0]} samples in rank-major"
        f" order (top1={float(serial['top1']):.6f} macro_precision@5={float(serial['precision']):.6f}"
        f" harmonic={float(serial['harmonic']):.6f} loss_mean={float(serial['loss_mean']):.6f}"
        f" confidences={serial['confidence'].numel()}); NCCL at world size 1 equals the unsynced result"
    )
    return {
        op: serial_stats[op]["launches"] + sum(rec["launches"][op] for rec in ranks)
        for op in ("select_topk", "confusion_counts")
    }


def _reset_stats(torch, mt):
    torch.cuda.synchronize()
    mt.reset_kernel_stats()
    return time.perf_counter()


def _read_stats(torch, mt, t0: float, expect: dict):
    """Seconds since ``t0``, and the kernel stats, which must show exactly
    ``expect`` launches per op, no launch of any other op and no plain call."""
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stats = mt.kernel_stats()
    got = {op: rec["launches"] for op, rec in stats.items() if rec["launches"]}
    if got != expect or any(rec["plain_calls"] for rec in stats.values()):
        raise AssertionError(f"launches {got}, expected {expect}; kernel_stats {stats}")
    return seconds, stats


def _close(name: str, got, want, atol: float = 0.0, rtol: float = 0.0) -> None:
    got = np.asarray(got.cpu().numpy() if hasattr(got, "cpu") else got, dtype=np.float64)
    if got.shape != np.shape(want) or not np.isfinite(got).all() or not np.allclose(got, want, rtol=rtol, atol=atol):
        err = np.abs(got - want).max() if got.shape == np.shape(want) else "shape"
        raise AssertionError(f"{name}: differs from the numpy oracle (max abs err {err}, atol {atol}, rtol {rtol})")


def _threshold_counts(scores: np.ndarray, positive: np.ndarray, ths: np.ndarray):
    """``(tp, fp, fn)`` of ``scores >= th`` per threshold, by binary search over sorted scores (O(N log N))."""
    pos = np.sort(scores[positive])
    neg = np.sort(scores[~positive])
    tp = len(pos) - np.searchsorted(pos, ths, side="left")
    fp = len(neg) - np.searchsorted(neg, ths, side="left")
    return tp, fp, len(pos) - tp


def _coco_curve_oracle(probs: np.ndarray, target: np.ndarray, ths: np.ndarray):
    """Per-label average precision and recall at precision >= MIN_PRECISION
    (with its threshold) over the binned curve, in float64."""
    eps = 1e-6  # METRIC_EPS
    counts = [_threshold_counts(probs[:, k], target[:, k] == 1, ths) for k in range(probs.shape[1])]
    tp, fp, fn = (np.stack([cnt[i] for cnt in counts]).astype(np.float64) for i in range(3))
    precision = np.concatenate([(tp + eps) / (tp + fp + eps), np.ones((len(tp), 1))], axis=1)
    recall = np.concatenate([tp / (tp + fn + eps), np.zeros((len(tp), 1))], axis=1)
    ap = -np.sum((recall[:, 1:] - recall[:, :-1]) * precision[:, :-1], axis=1)
    r_at_p, th_at_p = [], []
    for p, r in zip(precision[:, :-1], recall[:, :-1]):
        ok = p >= MIN_PRECISION
        best = max(zip(r[ok], p[ok], ths[ok])) if ok.any() else (0.0, 0.0, 0.0)
        r_at_p.append(best[0])
        th_at_p.append(1e6 if best[0] == 0.0 else best[2])
    return (tp, fp, fn), ap, np.array(r_at_p), np.array(th_at_p)


def run_coco_curves(torch, mt, rng):
    """MS-COCO 2014 val multilabel curves through the binned family."""
    n, c = COCO_VAL
    t_phase = time.perf_counter()
    target_np = (rng.random((n, c)) < 3 / c).astype(np.int64)  # about 3 labels per image
    logits = rng.standard_normal((n, c)) + 2.0 * target_np - 2.0
    probs_np = (1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    probs, target = torch.from_numpy(probs_np).cuda(), torch.from_numpy(target_np).cuda()
    mc = mt.MetricCollection(
        {
            "map": mt.BinnedAveragePrecision(num_classes=c, thresholds=THRESHOLDS),
            "r_at_p90": mt.BinnedRecallAtFixedPrecision(num_classes=c, min_precision=MIN_PRECISION, thresholds=THRESHOLDS),
        }
    )
    batches = _batches(n)
    t0 = _reset_stats(torch, mt)
    for s, e in batches:
        mc(probs[s:e], target[s:e])
    result = mc.compute()
    seconds, stats = _read_stats(torch, mt, t0, {"binned_counts": len(mc) * len(batches)})  # one per member per batch
    (tp, fp, fn), ap, r_at_p, th_at_p = _coco_curve_oracle(probs_np, target_np, mc["map"].thresholds.cpu().numpy())
    for member in mc.values():
        for name, want in zip(("TPs", "FPs", "FNs"), (tp, fp, fn)):
            if not np.array_equal(getattr(member, name).cpu().numpy(), want):
                raise AssertionError(f"coco curves {name}: counts differ from the numpy oracle")
    _require_programs("coco curves", mc, forward=True)
    _close("coco per-label AP", torch.stack(result["map"]), ap, atol=1e-6)
    _close("coco recall at precision 0.9", result["r_at_p90"][0], r_at_p, atol=1e-6)
    _close("coco threshold at precision 0.9", result["r_at_p90"][1], th_at_p, atol=1e-6)
    prof = _measure_batches(torch, [lambda s=s, e=e: mc(probs[s:e], target[s:e]) for s, e in batches[:PHASE_PROFILE_BATCHES]])
    _log(
        f"coco curves (9d): MS-COCO 2014 val, {n} samples x {c} labels, T={THRESHOLDS}, in {len(batches)} batches:"
        f" counts match the numpy oracle exactly, per-label AP and recall at precision {MIN_PRECISION} within 1e-6"
        f" (mAP={ap.mean():.6f}, mean R@P90={r_at_p.mean():.6f}); {n / seconds:.0f} samples/s"
        f" ({seconds * 1e3 / len(batches):.2f} ms/batch, first batch included); {_profile_note(prof)} (the per-class"
        f" compute loops gave 2142 device events and 2.961 ms of device time per batch before: PERF.md);"
        f" {_engine_note(mc)}; kernel_stats {stats}; phase {time.perf_counter() - t_phase:.1f} s"
    )
    return stats, (mc, probs, target)


def _ece_oracle(conf: np.ndarray, acc: np.ndarray, bounds: np.ndarray):
    """l1 calibration error over ``(b[i], b[i+1]]`` bins, in float64, and the bin counts."""
    bins = len(bounds) - 1
    idx = np.minimum(np.searchsorted(bounds, conf, side="left") - 1, bins - 1)
    keep = idx >= 0
    count = np.bincount(idx[keep], minlength=bins).astype(np.float64)
    conf_sum = np.bincount(idx[keep], weights=conf[keep].astype(np.float64), minlength=bins)
    acc_sum = np.bincount(idx[keep], weights=acc[keep].astype(np.float64), minlength=bins)
    filled = count > 0
    gap = np.abs(acc_sum[filled] / count[filled] - conf_sum[filled] / count[filled])
    return float(np.sum(gap * count[filled] / len(conf))), count


def run_imagenet_calibration(torch, mt, logits, target):
    """ImageNet-1k val calibration: streaming and buffered CalibrationError over phase 3's softmax."""
    probs, conf, acc = _top1_calibration(torch, logits, target)
    conf_np, acc_np = conf.cpu().numpy(), acc.cpu().numpy() == 1
    batches = _batches(len(target))
    out = {}
    for name, metric, expect in (
        ("streaming", mt.CalibrationError(n_bins=CAL_BINS, streaming_bins=True), len(batches)),
        ("buffered", mt.CalibrationError(n_bins=CAL_BINS), len(batches) + 1),  # a batch value per forward, then the epoch
    ):
        t0 = _reset_stats(torch, mt)
        for s, e in batches:
            metric(probs[s:e], target[s:e])
        value = metric.compute()
        seconds, stats = _read_stats(torch, mt, t0, {"binned_calibration": expect})
        ece, count = _ece_oracle(conf_np, acc_np, metric.bin_boundaries.cpu().numpy())
        _close(f"imagenet ECE ({name})", value, ece, rtol=1e-5)
        if name == "streaming" and not np.array_equal(metric.bin_count.cpu().numpy(), count):
            raise AssertionError("imagenet calibration: bin counts differ from the numpy oracle")
        if name == "streaming":
            _require_programs("imagenet calibration (streaming)", metric)
        out[name] = (metric, stats)
        _log(
            f"imagenet calibration ({name}): {len(target)} samples, {CAL_BINS} bins, in {len(batches)} batches:"
            f" ECE={float(value):.6f} matches the numpy oracle within 1e-5 relative; {len(target) / seconds:.0f} samples/s"
            f" ({seconds * 1e3 / len(batches):.2f} ms/batch); {_engine_note(metric)}; kernel_stats {stats}"
        )
    return out, probs


def _rank_auroc(scores: np.ndarray, positive: np.ndarray) -> float:
    """Exact AUROC as the Mann-Whitney statistic, ties counted half."""
    _, inverse, counts = np.unique(scores, return_inverse=True, return_counts=True)
    ends = np.cumsum(counts)
    mid_rank = ends - (counts - 1) / 2.0  # 1-based mean rank of each distinct score
    n_pos = positive.sum()
    n_neg = len(scores) - n_pos
    return float((mid_rank[inverse][positive].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _binned_auroc(scores: np.ndarray, positive: np.ndarray, ths: np.ndarray) -> float:
    tp, fp, fn = _threshold_counts(scores, positive, ths)
    tn = (~positive).sum() - fp
    tpr = np.concatenate([[0.0], (tp / (tp + fn))[::-1], [1.0]])
    fpr = np.concatenate([[0.0], (fp / (fp + tn))[::-1], [1.0]])
    return float(np.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2.0))


def _ctr_scores(rng, n: int):
    """Seeded scores of a CTR model and its clicks (about Criteo's click rate):
    most scores fall in a few of the 200 bins."""
    clicked = rng.random(n) < 0.034
    return (1.0 / (1.0 + np.exp(-(rng.standard_normal(n) + 1.2 * clicked - 3.0)))).astype(np.float32), clicked


def run_ctr_auroc(torch, mt, rng):
    """Binary AUROC over a CTR model's eval pass, binned beside exact."""
    n, batch = CTR_EVAL
    scores_np, clicked = _ctr_scores(rng, n)
    scores, labels = torch.from_numpy(scores_np).cuda(), torch.from_numpy(clicked.astype(np.int64)).cuda()
    mc = mt.MetricCollection({"auroc_binned": mt.AUROC(thresholds=THRESHOLDS), "auroc_exact": mt.AUROC()})
    batches = [(s, s + batch) for s in range(0, n, batch)]
    t0 = _reset_stats(torch, mt)
    for s, e in batches:
        mc(scores[s:e], labels[s:e])
    result = mc.compute()
    seconds, stats = _read_stats(torch, mt, t0, {"binned_counts": len(batches)})
    ths = mc["auroc_binned"].thresholds.cpu().numpy()
    tp, fp, fn = _threshold_counts(scores_np, clicked, ths)
    for name, want in zip(("bTPs", "bFPs", "bFNs", "bTNs"), (tp, fp, fn, (~clicked).sum() - fp)):
        if not np.array_equal(getattr(mc["auroc_binned"], name).cpu().numpy(), want):
            raise AssertionError(f"ctr binned AUROC {name}: counts differ from the numpy oracle")
    _require_programs("ctr binned AUROC", mc["auroc_binned"])
    binned = _binned_auroc(scores_np, clicked, ths)
    exact = _rank_auroc(scores_np, clicked)
    _close("ctr binned AUROC", result["auroc_binned"], binned, atol=1e-6)
    _close("ctr exact AUROC", result["auroc_exact"], exact, atol=1e-6)
    _log(
        f"ctr auroc: {n} binary samples in {len(batches)} batches of {batch}: binned counts match the numpy oracle exactly;"
        f" binned (T={THRESHOLDS}) {float(result['auroc_binned']):.6f} and exact {float(result['auroc_exact']):.6f} match theirs within 1e-6; {n / seconds:.0f} samples/s"
        f" ({seconds * 1e3 / len(batches):.2f} ms/batch, both members, first batch and the exact sort of all samples included); {_engine_note(mc)}; kernel_stats {stats}"
    )
    return stats, (mc, scores, labels)


def _cosine_mean_oracle(emb: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Mean cosine similarity of ``rows`` against every row, self excluded, in float64."""
    unit = emb / np.linalg.norm(emb.astype(np.float64), axis=1, keepdims=True)
    sims = unit[rows] @ unit.T
    sims[np.arange(len(rows)), rows] = 0.0
    return sims.sum(1) / len(emb)


def _euclidean_sum_oracle(query: np.ndarray, gallery: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Row sums of the euclidean distances of ``rows`` of ``query`` to every gallery row, in float64."""
    q = query[rows].astype(np.float64)
    g = gallery.astype(np.float64)
    sq = (q * q).sum(1)[:, None] + (g * g).sum(1)[None, :] - 2 * q @ g.T
    return np.sqrt(np.clip(sq, 0, None)).sum(1)


def run_pairwise_path(torch, mt, rng, emb):
    """The pairwise functionals at the published sizes of two deep-metric-learning test sets."""
    from metrics_tpu_torch.functional import pairwise_cosine_similarity, pairwise_euclidean_distance

    sop_np, query_np, gallery_np = emb["sop"], emb["query"], emb["gallery"]
    stats_total = {}
    timings = {}
    for label, fn, args, oracle, check in (
        (
            "sop cosine",
            lambda a: pairwise_cosine_similarity(a, reduction="mean"),
            (sop_np,),
            lambda rows: _cosine_mean_oracle(sop_np, rows),
            "1e-5 absolute",
        ),
        (
            "inshop euclidean",
            lambda a, b: pairwise_euclidean_distance(a, b, reduction="sum"),
            (query_np, gallery_np),
            lambda rows: _euclidean_sum_oracle(query_np, gallery_np, rows),
            "1e-5 relative",
        ),
    ):
        tensors = [torch.from_numpy(a).cuda() for a in args]
        t0 = _reset_stats(torch, mt)
        out = fn(*tensors)
        seconds, stats = _read_stats(torch, mt, t0, {"pairwise_reduce": 1})
        if out.dtype != torch.float32 or out.shape != (args[0].shape[0],) or not torch.isfinite(out).all():
            raise AssertionError(f"{label}: {out.dtype}{tuple(out.shape)} with non-finite values or of the wrong shape")
        rows = np.sort(rng.choice(args[0].shape[0], ORACLE_ROWS, replace=False))
        want = oracle(rows)
        got = out.cpu().numpy()[rows]
        if check.endswith("absolute"):
            _close(f"{label} row means", got, want, atol=1e-5)
        else:
            _close(f"{label} row sums", got, want, rtol=1e-5)
        stats_total[label] = stats["pairwise_reduce"]["launches"]
        timings[label] = (fn, tensors)
        _log(
            f"pairwise {label}: {' x '.join(str(list(a.shape)) for a in args)} -> [{args[0].shape[0]}] in"
            f" {seconds * 1e3:.2f} ms (first call); {ORACLE_ROWS} seeded rows match the numpy float64 oracle within {check}"
            f" (mean of the checked rows {float(np.mean(want)):.6f}); kernel_stats {stats}"
        )
    return sum(stats_total.values()), timings


def _regression_oracle(preds: np.ndarray, target: np.ndarray):
    """Every collection member's value over the whole stream, in float64 (sums taken in chunks)."""
    n = len(target)
    acc = dict.fromkeys(("se", "ae", "sle", "ape", "sape", "tw2", "sp", "st", "spp", "stt", "spt", "sd", "sdd"), 0.0)
    for s in range(0, n, 1 << 24):
        p = preds[s:s + (1 << 24)].astype(np.float64)
        t = target[s:s + (1 << 24)].astype(np.float64)
        d = t - p
        acc["se"] += np.dot(d, d)
        acc["ae"] += np.abs(d).sum()
        lg = np.log1p(p) - np.log1p(t)
        acc["sle"] += np.dot(lg, lg)
        acc["ape"] += (np.abs(d) / np.maximum(np.abs(t), 1.17e-06)).sum()
        acc["sape"] += (2 * np.abs(d) / np.maximum(np.abs(t) + np.abs(p), 1.17e-06)).sum()
        acc["tw2"] += (2 * (np.log(p / t) + t / p - 1)).sum()
        acc["sp"] += p.sum()
        acc["st"] += t.sum()
        acc["spp"] += np.dot(p, p)
        acc["stt"] += np.dot(t, t)
        acc["spt"] += np.dot(p, t)
        acc["sd"] += d.sum()
        acc["sdd"] += np.dot(d, d)
    var_t = acc["stt"] / n - (acc["st"] / n) ** 2
    var_p = acc["spp"] / n - (acc["sp"] / n) ** 2
    cov = acc["spt"] / n - acc["sp"] * acc["st"] / n**2
    return {
        "rmse": np.sqrt(acc["se"] / n),
        "mae": acc["ae"] / n,
        "msle": acc["sle"] / n,
        "mape": acc["ape"] / n,
        "smape": acc["sape"] / n,
        "r2": 1 - acc["se"] / (n * var_t),
        "explained_variance": 1 - (acc["sdd"] / n - (acc["sd"] / n) ** 2) / var_t,
        "pearson": cov / np.sqrt(var_p * var_t),
        "tweedie": acc["tw2"] / n,
        "spearman": _spearman_oracle(preds, target),
    }


def _mean_ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks of positive float32 values, ties at their mean rank, in
    O(N): positive floats order as their bit patterns, so a bincount over
    the patterns and its running sum give every value's rank block."""
    keys = x.view(np.int32)
    lo = int(keys.min())
    counts = np.bincount(keys - lo)
    ends = np.cumsum(counts)
    return (ends - (counts - 1) / 2.0)[keys - lo]


def _spearman_oracle(preds: np.ndarray, target: np.ndarray) -> float:
    assert (preds > 0).all() and (target > 0).all()
    rp, rt = _mean_ranks(preds), _mean_ranks(target)
    mid = (len(rp) + 1) / 2.0  # the mean of any rank vector
    rp -= mid
    rt -= mid
    return float(np.dot(rp, rt) / np.sqrt(np.dot(rp, rp) * np.dot(rt, rt)))


# Sum-type values 1e-5 relative; Pearson, R2 and explained variance 1e-4
# relative (float32 moments cancel: R2's total sum of squares is
# sum(t^2) - sum(t)^2/n); Spearman 1e-5 absolute (float32 ranks of 2e8
# values are rounded to 16).
REGRESSION_TOLERANCES = {
    "rmse": ("rtol", 1e-5), "mae": ("rtol", 1e-5), "msle": ("rtol", 1e-5), "mape": ("rtol", 1e-5),
    "smape": ("rtol", 1e-5), "tweedie": ("rtol", 1e-5), "r2": ("rtol", 1e-4),
    "explained_variance": ("rtol", 1e-4), "pearson": ("rtol", 1e-4), "spearman": ("atol", 1e-5),
}


def _nyu_collection(mt):
    return mt.MetricCollection(
        {
            "rmse": mt.MeanSquaredError(squared=False),
            "mae": mt.MeanAbsoluteError(),
            "msle": mt.MeanSquaredLogError(),
            "mape": mt.MeanAbsolutePercentageError(),
            "smape": mt.SymmetricMeanAbsolutePercentageError(),
            "r2": mt.R2Score(),
            "explained_variance": mt.ExplainedVariance(),
            "pearson": mt.PearsonCorrCoef(),
            "tweedie": mt.TweedieDevianceScore(power=2),
            "spearman": mt.SpearmanCorrCoef(),
        }
    )


def run_regression_path(torch, mt, rng):
    """NYU Depth v2 test-split depth regression, and teacher/student feature cosine similarity."""
    maps, h, w = NYU_TEST
    pixels = h * w
    target_np = rng.random(maps * pixels, dtype=np.float32) * np.float32(9.5) + np.float32(0.5)  # metres
    preds_np = target_np * np.exp(rng.standard_normal(maps * pixels, dtype=np.float32) * np.float32(0.12))
    target, preds = torch.from_numpy(target_np).cuda(), torch.from_numpy(preds_np).cuda()
    batches = [(s * pixels, min(s + NYU_BATCH, maps) * pixels) for s in range(0, maps, NYU_BATCH)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # Spearman's buffer-size warning
        mc = _nyu_collection(mt)
    t0 = _reset_stats(torch, mt)
    for s, e in batches:
        mc(preds[s:e], target[s:e])
    result = mc.compute()
    seconds, stats = _read_stats(torch, mt, t0, {})
    t1 = time.perf_counter()
    oracle = _regression_oracle(preds_np, target_np)
    oracle_s = time.perf_counter() - t1
    for key, want in oracle.items():
        kind, tol = REGRESSION_TOLERANCES[key]
        _close(f"nyu {key}", result[key], want, **{kind: tol})
    _require_programs("nyu depth regression", mc)
    shown = {k: round(float(v), 6) for k, v in result.items()}
    _log(
        f"nyu depth regression: {maps} maps x {h}x{w} = {maps * pixels} pixels in {len(batches)} batches of {NYU_BATCH} maps:"
        f" all 10 values match the numpy float64 oracle {shown}; {maps * pixels / seconds:.0f} pixels/s"
        f" ({seconds * 1e3 / len(batches):.2f} ms/batch, first batch and the final compute included);"
        f" oracle {oracle_s:.1f} s on the host; no kernel ran (kernel_stats {stats}); {_engine_note(mc)}"
    )

    n, d, batch = FEATURES
    teacher_np = np.abs(rng.standard_normal((n, d), dtype=np.float32))
    student_np = teacher_np + rng.standard_normal((n, d), dtype=np.float32) * np.float32(0.5)
    teacher, student = torch.from_numpy(teacher_np).cuda(), torch.from_numpy(student_np).cuda()
    cos = mt.CosineSimilarity(reduction="mean")
    feat_batches = _batches_of(n, batch)
    t0 = _reset_stats(torch, mt)
    for s, e in feat_batches:
        cos(student[s:e], teacher[s:e])
    value = cos.compute()
    cos_seconds, _ = _read_stats(torch, mt, t0, {})
    t64, s64 = teacher_np.astype(np.float64), student_np.astype(np.float64)
    want = float(np.mean((t64 * s64).sum(1) / (np.linalg.norm(t64, axis=1) * np.linalg.norm(s64, axis=1))))
    _close("feature cosine similarity", value, want, rtol=1e-5)
    _log(
        f"feature cosine similarity: ImageNet-1k val size, {n} x {d} in {len(feat_batches)} batches of {batch}:"
        f" {float(value):.6f} matches the numpy float64 oracle within 1e-5 relative;"
        f" {n / cos_seconds:.0f} samples/s ({cos_seconds * 1e3 / len(feat_batches):.2f} ms/batch)"
    )
    return (mc, preds, target, batches), (cos, student, teacher, feat_batches)


# ---------------------------------------------------------------------------
# the rest of classification and retrieval at full size (phases 9a-9e)
# ---------------------------------------------------------------------------
TEACHER_NOISE = 1.0  # the teacher's logits: the student's plus unit noise
DR_TEST = 53_576  # Kaggle Diabetic Retinopathy Detection test set: images
DR_GRADES = (0.735, 0.07, 0.15, 0.025, 0.02)  # its training labels' shares of grades 0-4
DR_OFF_BY = ((0, 1, -1, 2, -2), (0.62, 0.15, 0.15, 0.04, 0.04))  # a grader's error, in grades
CITYSCAPES_VAL = (500, 1024, 2048)  # Cityscapes val: images, height, width
SEG_BATCH = 8
SEG_CLASSES = 20  # the 19 evaluated classes and void (label 255, mapped to 19)
SEG_VOID = 19
SEG_BLOCK = 32  # labels hold over 32 x 32 pixel blocks, as regions of a street scene do
SEG_ERROR = 0.08  # share of non-void pixels predicted as another class
SEG_VOID_SHARE = 0.1
# rough pixel shares of the 19 classes (road, sidewalk, building, wall, fence,
# pole, traffic light, traffic sign, vegetation, terrain, sky, person, rider,
# car, truck, bus, train, motorcycle, bicycle), scaled below to 1 - SEG_VOID_SHARE
CITYSCAPES_SHARES = (
    0.33, 0.05, 0.2, 0.006, 0.008, 0.011, 0.002, 0.005, 0.14, 0.01,
    0.035, 0.011, 0.0013, 0.06, 0.0025, 0.002, 0.002, 0.0008, 0.0037,
)
DICE_BATCHES = 4
MSMARCO_DEV = (6_980, 1_000, 100)  # MS MARCO passage dev (small): queries, candidates each, queries per batch
MSMARCO_RELEVANT = ((0, 1, 2), (0.14, 0.8, 0.06))  # relevant passages among a query's candidates
PHASE_PROFILE_BATCHES = 3


def _measure_batches(torch, steps):
    """Per batch of ``steps``: wall ms, device ms, device events (torch.profiler)
    and host syncs (one more run of the first step); and the device rows."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in steps:
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(steps)
    rows = _device_rows(prof)
    device_ms = sum(r["device_us"] for r in rows) / 1e3 / len(steps)
    events = sum(r["calls"] for r in rows) / len(steps)
    busy_us, overlaps = _device_busy(prof)
    return {
        "wall_ms": wall_ms, "device_ms": device_ms, "busy_ms": busy_us / 1e3 / len(steps), "overlaps": overlaps,
        "events": events, "syncs": _host_syncs(torch, steps[0]), "rows": rows,
    }


def _device_busy(prof):
    """The time at least one device event runs (the union of their intervals
    in the trace), and the pairs of events that ran at once: (name of the
    event that started while the other ran, name of the other) -> count.
    Summed kernel time exceeds the busy time only where events overlap."""
    import collections

    intervals = sorted(
        (evt.time_range.start, evt.time_range.end, evt.name)
        for evt in prof.events()
        if "CUDA" in str(getattr(evt, "device_type", "")) and evt.time_range.end > evt.time_range.start
    )
    busy, end, running = 0.0, float("-inf"), ""
    overlaps = collections.Counter()
    for start, stop, name in intervals:
        if start < end:
            overlaps[(name[:40], running[:40])] += 1
        busy += max(0.0, stop - max(start, end))
        if stop > end:
            end, running = stop, name
    return busy, overlaps


def _profile_note(m, top: int = 0) -> str:
    """The profile of a phase's batches; with ``top``, its largest device ops
    (device us per batch, events per batch, name)."""
    n = PHASE_PROFILE_BATCHES
    ops = "; ".join(f"{r['device_us'] / n:.1f} us x{r['calls'] / n:g} {r['name'][:60]}" for r in m["rows"][:top])
    return (
        f"profiled (mean of {n} warm batches): {m['wall_ms']:.3f} ms wall, {m['device_ms']:.3f} ms device,"
        f" busy share {m['busy_ms'] / m['wall_ms']:.3f}, {m['events']:.0f} device events, {m['syncs']} host syncs per batch"
        + _overlap_note(m)
        + (f"; top device ops per batch: {ops}" if top else "")
    )


def _overlap_note(m) -> str:
    """Where the summed kernel time exceeds the device's busy time by over 1%: by how
    much, and which events ran at once (counts over the profiled batches)."""
    if m["device_ms"] <= m["busy_ms"] * 1.01:  # rounding at the edges of back-to-back kernels
        return ""
    pairs = ", ".join(f"{a} beside {b} x{c}" for (a, b), c in m["overlaps"].most_common(3))
    return (
        f" (device busy {m['busy_ms']:.3f} ms, the union of the kernels' intervals: they overlap for"
        f" {m['device_ms'] - m['busy_ms']:.3f} ms per batch, {sum(m['overlaps'].values())} overlapping starts: {pairs})"
    )


def _agreement_oracle(cm: np.ndarray, weights=None) -> float:
    """Cohen's kappa of a confusion matrix, in float64."""
    cm = cm.astype(np.float64)
    c = len(cm)
    expected = cm.sum(1, keepdims=True) @ cm.sum(0, keepdims=True) / cm.sum()
    diff = np.arange(c, dtype=np.float64)[None, :] - np.arange(c, dtype=np.float64)[:, None]
    w = 1.0 - np.eye(c) if weights is None else (np.abs(diff) if weights == "linear" else diff**2)
    return float(1.0 - (w * cm).sum() / (w * expected).sum())


def _mcc_oracle(cm: np.ndarray) -> float:
    cm = cm.astype(np.float64)
    tk, pk, c, s = cm.sum(1), cm.sum(0), np.trace(cm), cm.sum()
    denom = (s * s - (tk * tk).sum()) * (s * s - (pk * pk).sum())
    return 0.0 if denom == 0 else float((c * s - (tk * pk).sum()) / np.sqrt(denom))


def _hinge_oracles(logits_np: np.ndarray, target_np: np.ndarray):
    """Crammer-Singer mean hinge loss and the one-vs-all per-class means, in float64."""
    n, c = logits_np.shape
    cs, ova = 0.0, np.zeros(c)
    for s, e in _batches(n):
        x, t = logits_np[s:e].astype(np.float64), target_np[s:e]
        rows = np.arange(e - s)
        onehot = np.zeros_like(x, dtype=bool)
        onehot[rows, t] = True
        cs += np.maximum(0.0, 1.0 - (x[rows, t] - np.where(onehot, -np.inf, x).max(1))).sum()
        ova += np.maximum(0.0, 1.0 - np.where(onehot, x, -x)).sum(0)
    return cs / n, ova / n


def run_classification_extension(torch, mt, rng, logits, target, host_stream):
    """Phase 9a: Cohen's kappa, MCC, two hinge losses and a distillation KL
    over ImageNet-1k val in one collection; ``confusion_counts`` at
    [8192, 1000], twice per batch."""
    n, c = IMAGENET_VAL
    logits_np, target_np, oracle = host_stream
    t_phase = time.perf_counter()
    teacher = torch.from_numpy(logits_np + TEACHER_NOISE * rng.standard_normal((n, c), dtype=np.float32)).cuda()
    student_logp, teacher_logp = torch.log_softmax(logits, dim=1), torch.log_softmax(teacher, dim=1)
    del teacher
    mc = mt.MetricCollection(
        {
            "kappa": mt.CohenKappa(num_classes=c),
            "mcc": mt.MatthewsCorrCoef(num_classes=c),
            "hinge": mt.HingeLoss(),
            "hinge_ova": mt.HingeLoss(multiclass_mode="one-vs-all"),
            "kl": mt.KLDivergence(log_prob=True),
        }
    )
    batches = _batches(n)

    def step(s, e):
        return mc(preds=logits[s:e], target=target[s:e], p=teacher_logp[s:e], q=student_logp[s:e])

    t0 = _reset_stats(torch, mt)
    for s, e in batches:
        step(s, e)
    result = mc.compute()
    seconds, stats = _read_stats(torch, mt, t0, {"confusion_counts": 2 * len(batches)})
    _require_programs("classification extension", mc, forward=True, captured=True)
    for key in ("kappa", "mcc"):
        if not np.array_equal(mc[key].confmat.cpu().numpy(), oracle["confmat"]):
            raise AssertionError(f"classification extension {key}: counts differ from the numpy oracle")
    hinge, hinge_ova = _hinge_oracles(logits_np, target_np)
    p_np, q_np = teacher_logp.cpu().numpy(), student_logp.cpu().numpy()
    kl = sum((np.exp(p_np[s:e].astype(np.float64)) * (p_np[s:e].astype(np.float64) - q_np[s:e])).sum() for s, e in batches) / n
    _close("imagenet cohen kappa", result["kappa"], _agreement_oracle(oracle["confmat"]), rtol=1e-6)
    _close("imagenet mcc", result["mcc"], _mcc_oracle(oracle["confmat"]), rtol=1e-6)
    _close("imagenet hinge (crammer-singer)", result["hinge"], hinge, rtol=1e-5)
    _close("imagenet hinge (one-vs-all)", result["hinge_ova"], hinge_ova, rtol=1e-5)
    _close("imagenet distillation kl", result["kl"], kl, rtol=1e-5)
    prof = _measure_batches(torch, [lambda s=s, e=e: step(s, e) for s, e in batches[:PHASE_PROFILE_BATCHES]])
    _log(
        f"classification extension (9a): ImageNet-1k val, {n} x {c} logits and a teacher's, in {len(batches)} batches:"
        f" confusion counts match the numpy oracle exactly; kappa={float(result['kappa']):.6f} and"
        f" mcc={float(result['mcc']):.6f} within 1e-6, hinge={float(result['hinge']):.6f}, one-vs-all hinge over {c}"
        f" classes and kl={float(result['kl']):.6f} within 1e-5 relative of the float64 oracle;"
        f" {seconds * 1e3 / len(batches):.3f} ms/batch (first batch and captures included); {_profile_note(prof, top=4)};"
        f" {_engine_note(mc)} (every member captured: confusion, margins and the KL sum are fixed-shape programs);"
        f" kernel_stats {stats}; phase {time.perf_counter() - t_phase:.1f} s"
    )
    return stats["confusion_counts"]["launches"]


def run_ordinal_grading(torch, mt, rng):
    """Phase 9b: quadratic- and linear-weighted kappa of five-grade labels at
    the Kaggle Diabetic Retinopathy test set's size; ``confusion_counts`` at C = 5."""
    n = DR_TEST
    t_phase = time.perf_counter()
    target_np = rng.choice(5, n, p=DR_GRADES)
    preds_np = np.clip(target_np + rng.choice(DR_OFF_BY[0], n, p=DR_OFF_BY[1]), 0, 4)
    cm = np.bincount(target_np * 5 + preds_np, minlength=25).reshape(5, 5)
    preds, target = torch.from_numpy(preds_np).cuda(), torch.from_numpy(target_np).cuda()
    mc = mt.MetricCollection({"qwk": mt.CohenKappa(num_classes=5, weights="quadratic"), "lwk": mt.CohenKappa(num_classes=5, weights="linear")})
    batches = _batches(n)
    t0 = _reset_stats(torch, mt)
    marks = [t0]  # each batch apart: its warm-up runs and captures are one-time costs
    for s, e in batches:
        mc(preds[s:e], target[s:e])
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    result = mc.compute()
    seconds, stats = _read_stats(torch, mt, t0, {"confusion_counts": 2 * len(batches)})
    batch_ms = [round((b - a) * 1e3, 3) for a, b in zip(marks, marks[1:])]
    compute_ms = (t0 + seconds - marks[-1]) * 1e3
    _require_programs("ordinal grading", mc, forward=True, captured=True)
    for key in mc:
        if not np.array_equal(mc[key].confmat.cpu().numpy(), cm):
            raise AssertionError(f"ordinal grading {key}: counts differ from the numpy oracle")
    _close("retinopathy quadratic kappa", result["qwk"], _agreement_oracle(cm, "quadratic"), rtol=1e-6)
    _close("retinopathy linear kappa", result["lwk"], _agreement_oracle(cm, "linear"), rtol=1e-6)
    prof = _measure_batches(torch, [lambda s=s, e=e: mc(preds[s:e], target[s:e]) for s, e in batches[:PHASE_PROFILE_BATCHES]])
    _log(
        f"ordinal grading (9b): Kaggle Diabetic Retinopathy test size, {n} grades 0-4 in {len(batches)} batches:"
        f" 5 x 5 counts match the numpy oracle bit for bit; quadratic kappa={float(result['qwk']):.6f}, linear"
        f" kappa={float(result['lwk']):.6f} within 1e-6 of the float64 oracle; {seconds * 1e3 / len(batches):.3f} ms/batch"
        f" (first batch and captures included): per batch {batch_ms} ms, compute() {compute_ms:.3f} ms;"
        f" {_profile_note(prof)}; {_engine_note(mc)} (both captured);"
        f" kernel_stats {stats}; phase {time.perf_counter() - t_phase:.1f} s"
    )
    return stats["confusion_counts"]["launches"]


def _seg_batch(torch, gen, cdf, b: int):
    """One batch of street-scene labels (class per 32 x 32 block, void mapped
    to 19), the predicted labels (the true one but for SEG_ERROR of the
    non-void pixels; void pixels get a real class) and logits whose unique
    maximum is the predicted label."""
    _, h, w = CITYSCAPES_VAL
    blocks = torch.rand((b, h // SEG_BLOCK, w // SEG_BLOCK), device="cuda", generator=gen)
    target = torch.searchsorted(cdf, blocks).clamp(max=SEG_CLASSES - 1)
    target = target.repeat_interleave(SEG_BLOCK, dim=1).repeat_interleave(SEG_BLOCK, dim=2)
    wrong = torch.rand((b, h, w), device="cuda", generator=gen) < SEG_ERROR
    other = torch.randint(0, SEG_VOID, (b, h, w), device="cuda", generator=gen)
    pred = torch.where(wrong | (target == SEG_VOID), other, target)
    logits = torch.rand((b, SEG_CLASSES, h, w), device="cuda", generator=gen)
    logits.scatter_(1, pred.unsqueeze(1), 2.0)
    return logits, target, pred


def _iou_oracle(cm: np.ndarray):
    """Per-class IoU with the void row zeroed and the void class dropped, in float64."""
    cm = cm.astype(np.float64).copy()
    cm[SEG_VOID] = 0
    inter = np.diag(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    iou = np.divide(inter, union, out=np.zeros_like(inter), where=union > 0)
    return np.delete(iou, SEG_VOID)


def _dice_oracle(cm: np.ndarray) -> float:
    """Mean Dice over classes 1..C-1 (``bg=False``), in float64."""
    cm = cm.astype(np.float64)
    tp = np.diag(cm)
    fp, fn = cm.sum(0) - tp, cm.sum(1) - tp
    denom = 2 * tp + fp + fn
    score = np.where(cm.sum(1) > 0, np.divide(2 * tp, denom, out=np.zeros_like(tp), where=denom > 0), 0.0)
    return float(score[1:].mean())


def run_segmentation(torch, mt, rng, smi: str):
    """Phase 9c: mIoU and per-class IoU at Cityscapes val size, Dice on the
    first batches; ``confusion_counts`` at 16,777,216 rows and C = 20. Then
    the kernel against its plain version and ``torch.bincount`` on one
    batch's labels (PERF.md row 1b)."""
    from metrics_tpu_torch.functional import dice_score
    from metrics_tpu_torch.ops import confusion_counts as cc

    images, h, w = CITYSCAPES_VAL
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(rng.integers(2**31)))
    shares = np.array(CITYSCAPES_SHARES) / sum(CITYSCAPES_SHARES) * (1 - SEG_VOID_SHARE)
    cdf = torch.from_numpy(np.cumsum(np.append(shares, SEG_VOID_SHARE))[:-1].astype(np.float32)).cuda()
    mc = mt.MetricCollection(
        {
            "miou": mt.JaccardIndex(num_classes=SEG_CLASSES, ignore_index=SEG_VOID),
            "iou": mt.JaccardIndex(num_classes=SEG_CLASSES, ignore_index=SEG_VOID, reduction="none"),
        }
    )
    bounds = _batches_of(images, SEG_BATCH)
    cm = np.zeros((SEG_CLASSES, SEG_CLASSES), np.int64)
    metric_s, dice_s, dice = 0.0, 0.0, []
    kept = None
    t0 = _reset_stats(torch, mt)
    for i, (s, e) in enumerate(bounds):
        logits, target, pred = _seg_batch(torch, gen, cdf, e - s)
        torch.cuda.synchronize()
        t_batch = time.perf_counter()
        mc(logits, target)
        torch.cuda.synchronize()
        metric_s += time.perf_counter() - t_batch
        t8, p8 = target.to(torch.uint8).cpu().numpy().ravel(), pred.to(torch.uint8).cpu().numpy().ravel()
        batch_cm = np.bincount(t8.astype(np.int64) * SEG_CLASSES + p8, minlength=SEG_CLASSES**2).reshape(SEG_CLASSES, SEG_CLASSES)
        cm += batch_cm
        if i < DICE_BATCHES:
            torch.cuda.synchronize()
            t_dice = time.perf_counter()
            value = dice_score(torch.softmax(logits, dim=1), target)
            torch.cuda.synchronize()
            dice_s += time.perf_counter() - t_dice
            _close(f"cityscapes dice (batch {i})", value, _dice_oracle(batch_cm), rtol=1e-6)
            dice.append(float(value))
        if e - s == SEG_BATCH:
            kept = (logits, target, pred)
        del logits, target, pred
    t_compute = time.perf_counter()
    result = mc.compute()
    torch.cuda.synchronize()
    metric_s += time.perf_counter() - t_compute
    _, stats = _read_stats(torch, mt, t0, {"confusion_counts": len(mc) * len(bounds)})
    _require_programs("segmentation", mc, forward=True, captured=True)
    if cm.sum() != images * h * w:
        raise AssertionError(f"segmentation oracle: {cm.sum()} pixels for {images * h * w}")
    for key in mc:
        if not np.array_equal(mc[key].confmat.cpu().numpy(), cm):
            raise AssertionError(f"segmentation {key}: counts differ from the numpy oracle")
    iou = _iou_oracle(cm)
    _close("cityscapes mIoU", result["miou"], iou.mean(), rtol=1e-6)
    _close("cityscapes per-class IoU", result["iou"], iou, rtol=1e-6)
    logits, target, pred = kept
    prof = _measure_batches(torch, [lambda: mc(logits, target)] * PHASE_PROFILE_BATCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    _log(
        f"segmentation (9c): Cityscapes val size, {images} images of {h} x {w}, {SEG_CLASSES} classes (void {SEG_VOID}"
        f" ignored), in {len(bounds)} batches of up to {SEG_BATCH} ([{SEG_BATCH}, {SEG_CLASSES}, {h}, {w}] float32 logits):"
        f" {cm.sum()} pixel counts match the numpy oracle bit for bit (largest cell {cm.max()}, diagonal share"
        f" {np.trace(cm) / cm.sum():.3f}); mIoU={float(result['miou']):.6f} and the {SEG_CLASSES - 1} per-class IoUs within"
        f" 1e-6 relative; dice_score on {DICE_BATCHES} batches {[round(d, 6) for d in dice]} within 1e-6 of the oracle,"
        f" {dice_s * 1e3 / DICE_BATCHES:.3f} ms per call; {metric_s * 1e3 / len(bounds):.3f} ms/batch in the metrics (forward"
        f" and the final compute; data made on the card outside the timing; first batches and captures included);"
        f" {_profile_note(prof, top=8)}; peak memory {peak_gib:.1f} GiB; {_engine_note(mc)} (both captured; the formatter's one-hot"
        f" round trip runs inside); kernel_stats {stats}"
    )

    # confusion_counts at this shape: the kernel against its plain version and torch.bincount (PERF.md row 1b);
    # then the same shape in int32, and on uniform keys, where no warp aggregates
    p, t = pred.reshape(-1), target.reshape(-1)
    n = p.numel()
    err = _max_abs_err(torch, "confusion_counts[segmentation]", cc._confusion_counts_cuda(p, t, SEG_CLASSES), cc._confusion_counts_plain(p, t, SEG_CLASSES))
    ms = _cuda_ms(torch, lambda: cc._confusion_counts_cuda(p, t, SEG_CLASSES), iters=20)
    plain_ms = _cuda_ms(torch, lambda: cc._confusion_counts_plain(p, t, SEG_CLASSES), iters=5)
    library_ms = _cuda_ms(torch, lambda: torch.bincount(t * SEG_CLASSES + p, minlength=SEG_CLASSES**2), iters=20)
    bound_ms, bound_by = _bound_ms(2 * n * 8 + SEG_CLASSES**2 * 8, 5 * n)
    p32, t32 = p.int(), t.int()
    ms32 = _cuda_ms(torch, lambda: cc._confusion_counts_cuda(p32, t32, SEG_CLASSES), iters=20)
    bound32, _ = _bound_ms(2 * n * 4 + SEG_CLASSES**2 * 8, 5 * n)
    pu = torch.randint(0, SEG_CLASSES, (n,), device="cuda", generator=gen)
    tu = torch.randint(0, SEG_CLASSES, (n,), device="cuda", generator=gen)
    err = max(err, _max_abs_err(torch, "confusion_counts[segmentation, uniform]", cc._confusion_counts_cuda(pu, tu, SEG_CLASSES), cc._confusion_counts_plain(pu, tu, SEG_CLASSES)))
    ms_uniform = _cuda_ms(torch, lambda: cc._confusion_counts_cuda(pu, tu, SEG_CLASSES), iters=20)
    library_uniform = _cuda_ms(torch, lambda: torch.bincount(tu * SEG_CLASSES + pu, minlength=SEG_CLASSES**2), iters=20)
    _log(
        f"kernel confusion_counts at the segmentation shape (N={n}, C={SEG_CLASSES}, route {cc._confusion_route(SEG_CLASSES)},"
        f" diagonal-heavy labels in 32-pixel runs): bit-identical to plain (max abs err {err}); ms={ms:.4f} plain_ms={plain_ms:.4f}"
        f" library_ms={library_ms:.4f} (torch.bincount of target * C + preds) bound_ms={bound_ms:.4f} ({bound_by}), the kernel at"
        f" {bound_ms / ms:.3f} of the bound and {library_ms / ms:.2f}x the library's speed; int32 inputs ms={ms32:.4f} against"
        f" bound_ms={bound32:.4f} ({bound32 / ms32:.3f}); uniform keys ms={ms_uniform:.4f} ({bound_ms / ms_uniform:.3f} of the bound),"
        f" library_ms={library_uniform:.4f}; {smi}; phase {time.perf_counter() - t_phase:.1f} s"
    )
    record = dict(
        source="metrics_tpu_torch/csrc/confusion_counts.cu",
        replaces="metrics_tpu/ops/confusion_counts.py:44",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        shape=f"N={n}, C={SEG_CLASSES} (Cityscapes labels)",
    )
    calls = {"confusion_counts@segmentation": lambda: cc._confusion_counts_cuda(p, t, SEG_CLASSES)}
    return stats["confusion_counts"]["launches"], calls, record


def _msmarco_stream(rng):
    """Seeded passage-ranking data: every query's candidates, its relevant
    ones scored higher on average, scores rounded to two decimals (ties
    within queries, as BM25's); the rows of each batch of queries shuffled."""
    q, k, per_batch = MSMARCO_DEV
    n_rel = rng.choice(MSMARCO_RELEVANT[0], q, p=MSMARCO_RELEVANT[1])
    relevant = (np.arange(k)[None, :] < n_rel[:, None]).astype(np.int64)
    scores = np.round(rng.normal(12.0, 3.0, (q, k)) + 3.0 * relevant, 2).astype(np.float32)
    query = np.repeat(np.arange(q), k)
    order = np.concatenate([s * k + rng.permutation((min(s + per_batch, q) - s) * k) for s in range(0, q, per_batch)])
    bounds = [(s * k, min(s + per_batch, q) * k) for s in range(0, q, per_batch)]
    return scores.reshape(-1)[order], relevant.reshape(-1)[order], query[order], bounds


def _ranking_oracle(scores: np.ndarray, target: np.ndarray, query: np.ndarray):
    """The eight retrieval metrics over the stream, in float64: rows ordered by
    (query, descending score, position), every query holding the same
    number of candidates; queries with no relevant passage count 0."""
    q, k, _ = MSMARCO_DEV
    order = np.lexsort((np.arange(len(scores)), -scores, query))
    t = target[order].reshape(q, k).astype(np.float64)
    ranks = np.arange(k, dtype=np.float64)
    n_pos = t.sum(1)
    has = n_pos > 0
    safe = np.where(has, n_pos, 1.0)
    disc = 1.0 / np.log2(ranks + 2.0)
    idcg = np.array([disc[: int(min(p, 10))].sum() for p in n_pos])
    per_query = {
        "mrr": np.where(has, 1.0 / (t.argmax(1) + 1.0), 0.0),
        "map": np.where(has, (np.cumsum(t, 1) / (ranks + 1.0) * t).sum(1) / safe, 0.0),
        "r_precision": np.where(has, (t * (ranks[None, :] < n_pos[:, None])).sum(1) / safe, 0.0),
        "ndcg@10": np.where(idcg > 0, (t[:, :10] * disc[:10]).sum(1) / np.where(idcg > 0, idcg, 1.0), 0.0),
        "precision@10": np.where(has, t[:, :10].sum(1) / 10.0, 0.0),
        "hit_rate@10": (t[:, :10].sum(1) > 0).astype(np.float64),
        "fall_out@10": (1 - t[:, :10]).sum(1) / (1 - t).sum(1),
        "recall@100": np.where(has, t[:, :100].sum(1) / safe, 0.0),
    }
    return {key: float(v.mean()) for key, v in per_query.items()}, int((~has).sum())


def _check_ranking_order(torch, rng) -> int:
    """The rows' order within queries on the card equals the CPU's (and the
    numpy oracle's stable order) on ties, ``-0.0`` against ``0.0``, NaN and
    -inf scores and one-row queries; returns the rows checked."""
    from metrics_tpu_torch.functional.retrieval._ranking import _group_by_query

    n = 200_000
    scores = np.round(rng.standard_normal(n), 1).astype(np.float32)
    special = rng.random(n)
    scores[special < 0.05] = -0.0
    scores[(special >= 0.05) & (special < 0.1)] = 0.0
    scores[(special >= 0.1) & (special < 0.11)] = np.nan
    scores[(special >= 0.11) & (special < 0.12)] = -np.inf
    query = rng.integers(0, 5_000, n)
    query[:100] = np.arange(10**6, 10**6 + 100)  # one-row queries
    position = np.arange(n)
    want = position[np.lexsort((position, np.where(scores == 0, 0.0, -scores), query))]  # NaN last, -0.0 == 0.0
    args = [torch.from_numpy(a) for a in (scores, position, query)]
    cpu = _group_by_query(*args)
    card = _group_by_query(*(a.cuda() for a in args))
    for name, got in (("cpu", cpu), ("card", card)):
        if not np.array_equal(got.target.cpu().numpy(), want):
            raise AssertionError(f"ranking order on the {name} differs from numpy's stable order")
    if not torch.equal(card.rank.cpu(), cpu.rank) or not torch.equal(card.sizes.cpu(), cpu.sizes):
        raise AssertionError("ranks or query sizes differ between the card and the cpu")
    return n


def run_passage_ranking(torch, mt, rng):
    """Phase 9e: the eight retrieval metrics at MS MARCO passage dev (small)
    size, and a bounded ``RetrievalMAP`` beside them; no kernel."""
    q, k, per_batch = MSMARCO_DEV
    t_phase = time.perf_counter()
    order_rows = _check_ranking_order(torch, rng)
    scores_np, target_np, query_np, bounds = _msmarco_stream(rng)
    scores, target, query = (torch.from_numpy(a).cuda() for a in (scores_np, target_np, query_np))
    mc = mt.MetricCollection(
        {
            "mrr": mt.RetrievalMRR(),
            "map": mt.RetrievalMAP(),
            "r_precision": mt.RetrievalRPrecision(),
            "ndcg@10": mt.RetrievalNormalizedDCG(k=10),
            "precision@10": mt.RetrievalPrecision(k=10),
            "hit_rate@10": mt.RetrievalHitRate(k=10),
            "fall_out@10": mt.RetrievalFallOut(k=10),
            "recall@100": mt.RetrievalRecall(k=100),
        }
    )
    bounded = mt.RetrievalMAP(buffer_capacity=q * k)

    def step(s, e):
        return mc(scores[s:e], target[s:e], indexes=query[s:e])

    t0 = _reset_stats(torch, mt)
    for s, e in bounds:
        step(s, e)
    result = mc.compute()
    seconds, stats = _read_stats(torch, mt, t0, {})
    t1 = time.perf_counter()
    for s, e in bounds:
        bounded.update(scores[s:e], target[s:e], query[s:e])
    t2 = time.perf_counter()
    bounded_value = bounded.compute()
    torch.cuda.synchronize()
    bounded_s, bounded_compute_s = t2 - t1, time.perf_counter() - t2
    want, empty = _ranking_oracle(scores_np, target_np, query_np)
    for key, value in want.items():
        _close(f"ms marco {key}", result[key], value, atol=1e-6)
    if not torch.equal(bounded_value, result["map"]):
        raise AssertionError(f"ms marco: bounded RetrievalMAP {float(bounded_value)!r} differs from the unbounded {float(result['map'])!r}")
    _require_programs("bounded RetrievalMAP", bounded, captured=True)
    eager = sorted(k for k, m in mc.items() if m._has_list_state())
    if eager != sorted(mc.keys()) or _program_counts(mc)[0]:
        raise AssertionError(f"ms marco: list-state members {eager}, programs {mc.compile_stats()}")
    prof = _measure_batches(torch, [lambda s=s, e=e: step(s, e) for s, e in bounds[:PHASE_PROFILE_BATCHES]])
    prof_bounded = _measure_batches(
        torch, [lambda s=s, e=e: bounded.update(scores[s:e], target[s:e], query[s:e]) for s, e in bounds[:PHASE_PROFILE_BATCHES]]
    )
    _log(
        f"passage ranking (9e): MS MARCO passage dev (small) size, {q} queries x {k} candidates ({q * k} rows, {empty}"
        f" queries with no relevant passage, counted 0) in {len(bounds)} batches of up to {per_batch} queries"
        f" (the ranking order on the card equals the cpu's and numpy's on {order_rows} rows of ties, signed zeros,"
        f" NaN and -inf scores and one-row queries):"
        f" {({key: round(float(v), 6) for key, v in result.items()})} match the numpy float64 oracle within 1e-6;"
        f" {seconds * 1e3 / len(bounds):.3f} ms/batch (every member's batch value and the final compute);"
        f" {_profile_note(prof, top=4)}; programs: 0 captured, eager members {eager} (unbounded list states, and a compute"
        f" that reads the number of queries from the data, as in the JAX package); RetrievalMAP(buffer_capacity={q * k})"
        f" through the engine equals the unbounded member bit for bit, {bounded_s * 1e3 / len(bounds):.3f} ms/batch"
        f" (first batches and captures included), compute {bounded_compute_s * 1e3:.1f} ms, its update"
        f" {_profile_note(prof_bounded, top=4)}, {_engine_note(bounded)} (update captured; compute eager); kernel_stats {stats};"
        f" phase {time.perf_counter() - t_phase:.1f} s"
    )


# ---------------------------------------------------------------------------
# the wrappers, the state helpers and image quality (phases 11a-11d)
# ---------------------------------------------------------------------------
BOOTSTRAPS = 100
POISSON_BOOTSTRAPS = 10
BOOT_SEED = 42  # BootStrapper's default seed
BOOT_QUANTILES = (0.025, 0.975)
TRACKER_NOISE = (1.0, 0.0, 2.0)  # extra logit noise of each tracked epoch: the best epoch is the second
REGRESSION_OUTPUTS = (50_000, 3)  # a 3-D position regression: samples, outputs
NAN_SHARE = 0.01  # rows with a NaN in one output
CHECKPOINT_AFTER = 3  # batches before the save
DIV2K_VAL = (100, 3, 1020, 2040)  # DIV2K validation: images, channels, one crop shape with its 2040-pixel long side
DIV2K_BATCH = 4
DIV2K_NOISE = 0.05
ORACLE_IMAGES = 2
MS_SSIM_BETAS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
CONV_SYMBOLS = ("conv", "fprop", "xmma", "cudnn", "depthwise")  # the convolution's device kernels, by name


def _bootstrap_oracle(per_sample, batches, b: int, strategy: str, sizes=None):
    """Each replicate's sum of ``per_sample`` over its resamples and its
    resampled row count, from a twin of the wrapper's host sampler (the same
    draws in the same order)."""
    twin = np.random.default_rng(BOOT_SEED)
    sums, totals = np.zeros(b, np.int64), np.zeros(b, np.int64)
    for s, e in batches:
        n = e - s
        if strategy == "multinomial":
            idx = twin.integers(0, n, size=(b, n))
            sums += per_sample[s + idx].sum(1)
            totals += n
        else:
            for r in range(b):
                rows = np.repeat(np.arange(n), twin.poisson(1.0, size=n))
                sums[r] += per_sample[s + rows].sum()
                totals[r] += len(rows)
    return sums, totals


def _mcc_bootstrap_oracle(target_np, pred1, batches, b: int, c: int):
    """Each multinomial replicate's ``[C, C]`` confusion counts."""
    twin = np.random.default_rng(BOOT_SEED)
    cms = np.zeros((b, c * c), np.int64)
    for s, e in batches:
        idx = s + twin.integers(0, e - s, size=(b, e - s))
        keys = target_np[idx] * c + pred1[idx]
        for r in range(b):
            cms[r] += np.bincount(keys[r], minlength=c * c)
    return cms.reshape(b, c, c)


def _bootstrap_stats(values: np.ndarray):
    return {
        "mean": values.mean(),
        "std": values.std(ddof=1),
        "quantile": np.quantile(values, BOOT_QUANTILES),
    }


def _check_bootstrap(name: str, result: dict, values: np.ndarray) -> None:
    """The replicates' values within 1e-6 relative of the oracle's, then
    their statistics within 1e-6."""
    _close(f"{name} replicates", result["raw"], values, rtol=1e-6)
    for key, want in _bootstrap_stats(values).items():
        if key in result:
            _close(f"{name} {key}", result[key], want, atol=1e-6)


def _run_bootstrap(torch, mt, boot, logits, target, batches, expect: dict):
    """Stream ImageNet-1k val through ``boot.update``, then ``compute()``;
    ms/batch, the launches per op, the peak memory."""
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = _reset_stats(torch, mt)
    for s, e in batches:
        boot.update(logits[s:e], target[s:e])
    seconds, stats = _read_stats(torch, mt, t0, expect)
    t1 = time.perf_counter()
    result = boot.compute()
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() - base_mem
    return result, seconds * 1e3 / len(batches), compute_s * 1e3, peak, stats


def _bootstrap_note(torch, boot, logits, target, batches, ms_batch, compute_ms, peak, stats) -> str:
    """Its programs, and a profile of a few more batches (after the checks)."""
    from metrics_tpu_torch.engine import cache

    tmpl = boot.compile_stats()["children"]["template"]
    graphs = [
        g for key, entry in list(cache._CACHE.items())
        if key[0] == "bootstrap_update" and key[1] == boot._template._engine_key for g in entry.graphs
    ]
    per_replay = sorted({json.dumps(g.launches, sort_keys=True) for g in graphs})
    prof = _measure_batches(torch, [lambda s=s, e=e: boot.update(logits[s:e], target[s:e]) for s, e in batches[:PHASE_PROFILE_BATCHES]])
    return (
        f"{ms_batch:.3f} ms/batch over the stream (first batch of each shape, its eager warm-up and capture included),"
        f" compute() {compute_ms:.1f} ms; {_profile_note(prof, top=4)}; template programs: {tmpl['compiles']} captured,"
        f" {tmpl['cache_hits']} cache hits, jit_failed {tmpl['jit_failed']}; launches credited per replay {per_replay};"
        f" peak memory above the phase's start {peak / 2**30:.2f} GiB; kernel_stats {stats}"
    )


def run_wrappers_phase(torch, mt, logits, target, host_stream):
    """Phase 11a: the wrappers over ImageNet-1k val. Returns the launches per op."""
    n, c = IMAGENET_VAL
    logits_np, target_np, oracle = host_stream
    t_phase = time.perf_counter()
    batches = _batches(n)
    rows = np.arange(n)
    t_score = logits_np[rows, target_np][:, None]
    cols = np.arange(c)[None, :]
    rank = (logits_np > t_score).sum(1) + ((logits_np == t_score) & (cols < target_np[:, None])).sum(1)
    top5 = (rank < TOP_K).astype(np.int64)
    pred1 = logits_np.argmax(1)
    top1 = (pred1 == target_np).astype(np.int64)
    launches = {"select_topk": 0, "confusion_counts": 0}
    b = BOOTSTRAPS

    # (1) top-5 accuracy, multinomial: the fast path, select_topk once per replicate
    boot = mt.BootStrapper(
        mt.Accuracy(num_classes=c, top_k=TOP_K), num_bootstraps=b, sampling_strategy="multinomial",
        quantile=list(BOOT_QUANTILES), raw=True,
    )
    result, ms_batch, compute_ms, peak, stats = _run_bootstrap(
        torch, mt, boot, logits, target, batches, {"select_topk": b * len(batches)}
    )
    _require_bootstrap_fast_path("BootStrapper(Accuracy(top_k=5))", boot, len(batches))
    correct, totals = _bootstrap_oracle(top5, batches, b, "multinomial")
    st = {k: v.cpu().numpy() for k, v in boot._stacked_state.items()}  # micro stat scores: tp = right, tp + fn = all
    if not (np.array_equal(st["tp"], correct) and np.array_equal(st["tp"] + st["fn"], totals)):
        raise AssertionError("bootstrap top-5 accuracy: replicate counts differ from the numpy oracle")
    _check_bootstrap("bootstrap top-5 accuracy", result, correct / totals)
    launches["select_topk"] += stats["select_topk"]["launches"]
    _log(
        f"wrappers (11a) BootStrapper(Accuracy(top_k=5)), {b} multinomial replicates over ImageNet-1k val ({n} x {c},"
        f" {len(batches)} batches): every replicate's counts equal the numpy oracle's (indices redrawn from a twin"
        f" default_rng({BOOT_SEED})) bit for bit, values within 1e-6 relative; mean={float(result['mean']):.6f}"
        f" std={float(result['std']):.6f} quantiles={[round(float(q), 6) for q in result['quantile']]} within 1e-6;"
        f" {_bootstrap_note(torch, boot, logits, target, batches, ms_batch, compute_ms, peak, stats)}"
    )
    del boot, st

    # (2) MCC, multinomial: the fast path, confusion_counts once per replicate
    boot = mt.BootStrapper(mt.MatthewsCorrCoef(num_classes=c), num_bootstraps=b, sampling_strategy="multinomial", raw=True)
    result, ms_batch, compute_ms, peak, stats = _run_bootstrap(
        torch, mt, boot, logits, target, batches, {"confusion_counts": b * len(batches)}
    )
    _require_bootstrap_fast_path("BootStrapper(MatthewsCorrCoef)", boot, len(batches))
    cms = _mcc_bootstrap_oracle(target_np, pred1, batches, b, c)
    if not np.array_equal(boot._stacked_state["confmat"].cpu().numpy(), cms):
        raise AssertionError("bootstrap mcc: replicate confusion counts differ from the numpy oracle")
    _check_bootstrap("bootstrap mcc", result, np.array([_mcc_oracle(cm) for cm in cms]))
    launches["confusion_counts"] += stats["confusion_counts"]["launches"]
    _log(
        f"wrappers (11a) BootStrapper(MatthewsCorrCoef), {b} multinomial replicates over ImageNet-1k val: every"
        f" replicate's {c} x {c} counts equal the numpy oracle's bit for bit, values within 1e-6 relative;"
        f" mean={float(result['mean']):.6f} std={float(result['std']):.6f} within 1e-6;"
        f" {_bootstrap_note(torch, boot, logits, target, batches, ms_batch, compute_ms, peak, stats)}"
    )
    del boot

    # (3) top-1 accuracy, poisson (the default): eager clones
    boot = mt.BootStrapper(mt.Accuracy(num_classes=c), num_bootstraps=POISSON_BOOTSTRAPS, raw=True, quantile=list(BOOT_QUANTILES))
    result, ms_batch, compute_ms, peak, stats = _run_bootstrap(torch, mt, boot, logits, target, batches, {})
    if boot._use_fast_path is not False or any(s["compiles"] for s in boot.compile_stats()["children"].values()):
        raise AssertionError(f"poisson BootStrapper: expected eager clones, got {boot.compile_stats()}")
    correct, totals = _bootstrap_oracle(top1, batches, POISSON_BOOTSTRAPS, "poisson")
    counts = [(int(m.tp), int(m.tp + m.fn)) for m in boot.metrics]
    if counts != list(zip(correct.tolist(), totals.tolist())):
        raise AssertionError(f"poisson bootstrap: replicate counts {counts} differ from the oracle's")
    _check_bootstrap("poisson bootstrap top-1 accuracy", result, correct / totals)
    prof = _measure_batches(torch, [lambda s=s, e=e: boot.update(logits[s:e], target[s:e]) for s, e in batches[:PHASE_PROFILE_BATCHES]])
    _log(
        f"wrappers (11a) BootStrapper(Accuracy()), {POISSON_BOOTSTRAPS} poisson replicates (eager clones, as in JAX):"
        f" counts equal the oracle's, values within 1e-6 relative, mean={float(result['mean']):.6f}"
        f" std={float(result['std']):.6f}; {ms_batch:.3f} ms/batch, compute() {compute_ms:.1f} ms;"
        f" {_profile_note(prof, top=2)}; peak memory above the phase's start {peak / 2**30:.2f} GiB"
    )
    del boot

    # (4) MinMaxMetric through forward: the batch values fold into the trackers
    mm = mt.MinMaxMetric(mt.Accuracy(num_classes=c))
    lo, hi = np.inf, -np.inf
    t0 = _reset_stats(torch, mt)
    for s, e in batches:
        out = mm(logits[s:e], target[s:e])
        want = top1[s:e].mean()
        lo, hi = min(lo, want), max(hi, want)
        _close("minmax batch value", out["raw"], want, rtol=1e-6)
        _close("minmax running max", out["max"], hi, rtol=1e-6)
        _close("minmax running min", out["min"], lo, rtol=1e-6)
    final = mm.compute()
    seconds, _ = _read_stats(torch, mt, t0, {})
    _close("minmax raw", final["raw"], top1.mean(), rtol=1e-6)
    _close("minmax max", final["max"], max(hi, top1.mean()), rtol=1e-6)
    _close("minmax min", final["min"], min(lo, top1.mean()), rtol=1e-6)

    # (5) ClasswiseWrapper: 1000 per-class recalls
    cw = mt.ClasswiseWrapper(mt.Recall(num_classes=c, average=None))
    t1 = _reset_stats(torch, mt)
    for s, e in batches:
        cw.update(logits[s:e], target[s:e])
    per_class = cw.compute()
    cw_seconds, _ = _read_stats(torch, mt, t1, {})
    cm = oracle["confmat"]
    recall = np.diag(cm) / cm.sum(1)
    if list(per_class) != [f"recall_{i}" for i in range(c)]:
        raise AssertionError(f"classwise: keys {list(per_class)[:3]}...")
    _close("classwise recall", torch.stack(list(per_class.values())), recall, rtol=1e-6)
    _log(
        f"wrappers (11a) MinMaxMetric(Accuracy()) through forward: {len(batches)} batch values and the running min/max"
        f" equal the oracle's within 1e-6 ({seconds * 1e3 / len(batches):.3f} ms/batch, {_engine_note(mm._base_metric)});"
        f" ClasswiseWrapper(Recall(average=None)): {len(per_class)} keys recall_0..recall_{c - 1}, equal the oracle's"
        f" per-class recall within 1e-6 ({cw_seconds * 1e3 / len(batches):.3f} ms/batch)"
    )

    # (6) MetricTracker over the main path's collection, three epochs at three noise levels
    tracker = mt.MetricTracker(_imagenet_collection(mt), maximize=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    want_steps, tracker_s = [], 0.0
    t2 = _reset_stats(torch, mt)
    for noise in TRACKER_NOISE:
        epoch = logits + noise * torch.randn(logits.shape, generator=gen, device="cuda")
        tracker.increment()
        torch.cuda.synchronize()
        t_epoch = time.perf_counter()
        for s, e in batches:
            tracker(epoch[s:e], target[s:e])
        torch.cuda.synchronize()
        tracker_s += time.perf_counter() - t_epoch
        want_steps.append(_numpy_oracle(epoch.cpu().numpy(), target_np, c))
        del epoch
    _, tracker_stats = _read_stats(
        torch, mt, t2, {"confusion_counts": len(TRACKER_NOISE) * len(batches), "select_topk": len(TRACKER_NOISE) * len(batches)}
    )
    steps_all = tracker.compute_all()
    idx, best = tracker.best_metric(return_step=True)
    for key in ("top1", "top5", "f1"):
        values = np.array([w[key] for w in want_steps])
        _close(f"tracker {key} per step", steps_all[key], values, rtol=1e-6)
        if idx[key] != int(values.argmax()):
            raise AssertionError(f"tracker best step of {key}: {idx[key]}, oracle {int(values.argmax())}")
        _close(f"tracker best {key}", torch.tensor(best[key]), values.max(), rtol=1e-6)
    if not np.array_equal(steps_all["confmat"].cpu().numpy(), np.stack([w["confmat"] for w in want_steps])) or "confmat" in best:
        raise AssertionError("tracker: per-step confusion counts differ from the oracle, or a non-scalar member has a best value")
    for op in ("select_topk", "confusion_counts"):
        launches[op] += tracker_stats[op]["launches"]
    _log(
        f"wrappers (11a) MetricTracker over the main path's collection, {len(TRACKER_NOISE)} epochs of ImageNet-1k val"
        f" at logit noise {TRACKER_NOISE}: per-step values within 1e-6 and counts bit for bit of the oracle's;"
        f" best_metric(return_step=True) {idx}, {({k: round(v, 6) for k, v in best.items()})} matches;"
        f" {tracker_s * 1e3 / (len(TRACKER_NOISE) * len(batches)):.3f} ms/batch (the noisy logits and the oracle outside"
        f" the time; each epoch's clone captures anew); kernel_stats {tracker_stats}; phase {time.perf_counter() - t_phase:.1f} s"
    )
    return launches


def _require_bootstrap_fast_path(name: str, boot, n_batches: int) -> None:
    """The fast path ran: one program per input signature (the full batches
    and the ragged tail), replayed for every other batch; no fallback."""
    tmpl = boot.compile_stats()["children"]["template"]
    if boot._use_fast_path is not True or tmpl["jit_failed"] or tmpl["compiles"] != 2 or tmpl["cache_hits"] != n_batches - 2:
        raise AssertionError(f"{name}: not on the captured fast path: use_fast_path={boot._use_fast_path}, template {tmpl}")


def run_multioutput_phase(torch, mt):
    """Phase 11b: ``MultioutputWrapper(MeanAbsoluteError(), num_outputs=3)``
    over 50,000 x 3 outputs, 1% of rows NaN in one output."""
    rng = np.random.default_rng(SEED + 11)  # its own stream: the later phases keep their data
    n, k = REGRESSION_OUTPUTS
    target_np = rng.standard_normal((n, k)).astype(np.float32)
    preds_np = (target_np + 0.1 * rng.standard_normal((n, k))).astype(np.float32)
    bad = rng.choice(n, int(n * NAN_SHARE), replace=False)
    preds_np[bad, rng.integers(0, k, len(bad))] = np.nan
    want = [
        np.abs(preds_np[:, o].astype(np.float64) - target_np[:, o])[~np.isnan(preds_np[:, o])].mean() for o in range(k)
    ]
    preds, target = torch.from_numpy(preds_np).cuda(), torch.from_numpy(target_np).cuda()
    mo = mt.MultioutputWrapper(mt.MeanAbsoluteError(), num_outputs=k)
    batches = _batches(n)
    t0 = _reset_stats(torch, mt)
    for s, e in batches:
        mo.update(preds[s:e], target[s:e])
    result = mo.compute()
    seconds, _ = _read_stats(torch, mt, t0, {})
    for o in range(k):
        _close(f"multioutput mae output {o}", result[o], want[o], rtol=1e-5)
    syncs = _host_syncs(torch, lambda: mo.update(preds[:BATCH], target[:BATCH]))
    _log(
        f"multioutput (11b): MultioutputWrapper(MeanAbsoluteError(), num_outputs={k}) over {n} rows x {k} outputs,"
        f" {len(bad)} rows NaN in one output: each output's MAE within 1e-5 relative of numpy with its NaN rows dropped"
        f" ({[round(float(v), 6) for v in result]}); {seconds * 1e3 / len(batches):.3f} ms/batch, {syncs} host syncs per"
        f" batch (the kept counts of all outputs in one read)"
    )


def run_checkpoint_phase(torch, mt, logits, target):
    """Phase 11c: checkpoints on the card. Returns the launches per op."""
    import tempfile

    from metrics_tpu_torch.utils import checkpoint as ckpt

    batches = _batches(IMAGENET_VAL[0])
    whole, first = _imagenet_collection(mt), _imagenet_collection(mt)
    t0 = _reset_stats(torch, mt)
    for s, e in batches:
        whole.update(logits[s:e], target[s:e])
    for s, e in batches[:CHECKPOINT_AFTER]:
        first.update(logits[s:e], target[s:e])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "imagenet.pt")
        t_save = time.perf_counter()
        ckpt.save_metric_state(path, first)
        save_ms = (time.perf_counter() - t_save) * 1e3
        size = os.path.getsize(path)
        resumed = _imagenet_collection(mt)
        t_load = time.perf_counter()
        ckpt.load_metric_state(path, resumed)
        load_ms = (time.perf_counter() - t_load) * 1e3
    for s, e in batches[CHECKPOINT_AFTER:]:
        resumed.update(logits[s:e], target[s:e])
    n_updates = 2 * len(batches)
    _, stats = _read_stats(torch, mt, t0, {"confusion_counts": n_updates, "select_topk": n_updates})
    device = whole["top1"].device  # the card: metrics live there unless told otherwise
    if any(v.device.type != device.type for _, m in resumed.items() for v in m._snapshot_state().values()):
        raise AssertionError(f"checkpoint: restored states are not on {device}")
    want, got = whole.compute(), resumed.compute()
    _same_values("checkpoint: the resumed collection against the uninterrupted one", got, want)

    cpu = _imagenet_collection_with(mt, device="cpu")
    for key, m in whole.items():
        ckpt.restore_metric_state_pytree(cpu[key], ckpt.metric_state_pytree(m))
    on_cpu = cpu.compute()
    if not np.array_equal(on_cpu["confmat"].numpy(), want["confmat"].cpu().numpy()):
        raise AssertionError("checkpoint: the cpu restore's counts differ")
    for key in ("top1", "top5", "f1"):
        _close(f"checkpoint cpu restore {key}", on_cpu[key], float(want[key]), rtol=1e-6)

    fewer = IMAGENET_VAL[1] - 1
    fewer_cm = mt.ConfusionMatrix(num_classes=fewer)
    t1 = _reset_stats(torch, mt)
    fewer_cm.update(target[:BATCH] % fewer, target[:BATCH] % fewer)
    _read_stats(torch, mt, t1, {"confusion_counts": 1})
    before = fewer_cm.confmat.clone()
    try:
        ckpt.restore_metric_state_pytree(fewer_cm, ckpt.metric_state_pytree(whole["confmat"]))
    except ValueError as err:
        refused = str(err)
    else:
        raise AssertionError(f"checkpoint: a {fewer + 1}-class tree restored into a {fewer}-class ConfusionMatrix")
    if not torch.equal(fewer_cm.confmat, before) or fewer_cm._update_count != 1:
        raise AssertionError("checkpoint: the refused restore changed the target")
    _log(
        f"checkpoints (11c): the ImageNet-1k collection saved after {CHECKPOINT_AFTER} of {len(batches)} batches"
        f" ({size / 2**20:.1f} MiB, save {save_ms:.1f} ms, load {load_ms:.1f} ms, weights_only), resumed on {device} and fed"
        f" the rest equals the uninterrupted run bit for bit (counts and values); a tree taken on the card restores"
        f" into a cpu collection with the same counts and values within 1e-6; a {fewer}-class ConfusionMatrix refuses it"
        f" ({refused[:90]}...) and keeps its state; kernel_stats {stats}"
    )
    return {"confusion_counts": n_updates + 1, "select_topk": n_updates}


def _ssim_maps_oracle(p: np.ndarray, t: np.ndarray, data_range: float = 1.0):
    """Float64 SSIM and contrast-sensitivity maps of one ``[C, H, W]`` image:
    separable gaussian windows (11 taps, sigma 1.5) with scipy's ``mirror``
    edges, which is numpy's (and torch's) ``reflect``."""
    from scipy.ndimage import correlate1d

    x = np.arange(-5, 6, dtype=np.float64)
    g = np.exp(-((x / 1.5) ** 2) / 2)
    g /= g.sum()

    def blur(a):
        return correlate1d(correlate1d(a, g, axis=-2, mode="mirror"), g, axis=-1, mode="mirror")

    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    mu_p, mu_t = blur(p), blur(t)
    s_pp, s_tt, s_pt = blur(p * p) - mu_p**2, blur(t * t) - mu_t**2, blur(p * t) - mu_p * mu_t
    cs = (2 * s_pt + c2) / (s_pp + s_tt + c2)
    return (2 * mu_p * mu_t + c1) / (mu_p**2 + mu_t**2 + c1) * cs, cs


def _image_oracle(p: np.ndarray, t: np.ndarray):
    """SSIM and MS-SSIM of one image in float64 (SSIM is the first scale's)."""
    sims, css = [], []
    for _ in MS_SSIM_BETAS:
        sim, cs = _ssim_maps_oracle(p, t)
        sims.append(sim.mean())
        css.append(cs.mean())
        h, w = p.shape[-2] // 2 * 2, p.shape[-1] // 2 * 2
        p = p[:, :h, :w].reshape(p.shape[0], h // 2, 2, w // 2, 2).mean((2, 4))
        t = t[:, :h, :w].reshape(t.shape[0], h // 2, 2, w // 2, 2).mean((2, 4))
    betas = np.array(MS_SSIM_BETAS)
    return sims[0], np.prod(np.array(css[:-1]) ** betas[:-1]) * sims[-1] ** betas[-1]


def run_image_phase(torch, mt, smi: str):
    """Phase 11d: PSNR, SSIM and MS-SSIM at DIV2K validation size."""
    from torch.profiler import ProfilerActivity, profile

    from metrics_tpu_torch.functional import multiscale_structural_similarity_index_measure as ms_ssim_fn
    from metrics_tpu_torch.functional import structural_similarity_index_measure as ssim_fn

    t_phase = time.perf_counter()
    n, ch, h, w = DIV2K_VAL
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    target = torch.rand((n, ch, h, w), generator=gen, device="cuda")
    preds = (target + DIV2K_NOISE * torch.randn((n, ch, h, w), generator=gen, device="cuda")).clamp_(0.0, 1.0)
    bounds = _batches_of(n, DIV2K_BATCH)

    # the first images against the float64 scipy oracle, per image
    for i in range(ORACLE_IMAGES):
        p_np, t_np = preds[i].double().cpu().numpy(), target[i].double().cpu().numpy()
        want_ssim, want_ms = _image_oracle(p_np, t_np)
        _close(f"div2k image {i} ssim", ssim_fn(preds[i : i + 1], target[i : i + 1], data_range=1.0), want_ssim, atol=1e-5)
        _close(f"div2k image {i} ms-ssim", ms_ssim_fn(preds[i : i + 1], target[i : i + 1], data_range=1.0), want_ms, atol=1e-5)

    # the same metrics in float64 on the card, a batch at a time (a whole-stream float64 compute would not fit)
    sse64 = ssim_sum64 = 0.0
    ms64 = []
    for s, e in bounds:
        p64, t64 = preds[s:e].double(), target[s:e].double()
        sse64 += float(((p64 - t64) ** 2).sum())
        ssim_sum64 += float(ssim_fn(p64, t64, data_range=1.0, reduction="sum"))
        ms64.append(ms_ssim_fn(p64, t64, data_range=1.0, reduction="none"))
        del p64, t64
    want = {
        "psnr": 10 * np.log10(1.0 / (sse64 / preds.numel())),
        "ssim": ssim_sum64 / preds.numel(),
        "ms_ssim": float(torch.cat(ms64).mean()),
    }

    lines = []
    for key, make in (
        ("psnr", lambda: mt.PeakSignalNoiseRatio(data_range=1.0)),
        ("ssim", lambda: mt.StructuralSimilarityIndexMeasure(data_range=1.0)),
        ("ms_ssim", lambda: mt.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0)),
    ):
        metric = make()
        t0 = _reset_stats(torch, mt)
        for s, e in bounds:
            metric.update(preds[s:e], target[s:e])
        update_s, _ = _read_stats(torch, mt, t0, {})
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        value = metric.compute()
        torch.cuda.synchronize()
        compute_ms = (time.perf_counter() - t1) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        _close(f"div2k {key} (float32) against float64", value, want[key], atol=1e-5)
        for _ in range(PROFILE_ATTEMPTS):  # the profiler now and then records no device event
            metric._computed = None
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                metric.compute()
                torch.cuda.synchronize()
            rows = _device_rows(prof)
            if rows:
                break
        total_us = sum(r["device_us"] for r in rows)
        conv_us = sum(r["device_us"] for r in rows if any(k in r["name"].lower() for k in CONV_SYMBOLS))
        top = "; ".join(f"{r['device_us'] / 1e3:.3f} ms x{r['calls']} {r['name'][:50]}" for r in rows[:4])
        lines.append(
            f"{key}: {float(value):.6f} (float64 {want[key]:.6f}), update {update_s * 1e3 / len(bounds):.3f} ms,"
            f" compute() {compute_ms:.1f} ms, compute's device time {total_us / 1e3:.3f} ms"
            f" (convolution {conv_us / max(total_us, 1e-9):.1%}; top: {top}), compute's peak memory above the"
            f" buffered stream {peak / 2**30:.2f} GiB; {_engine_note(metric)}"
        )
        del metric, value
        torch.cuda.empty_cache()
    _log(
        f"image quality (11d): DIV2K val size, {n} RGB float32 images of {h} x {w} in batches of {DIV2K_BATCH}"
        f" (made on the card, noise sigma {DIV2K_NOISE}); per-image SSIM and MS-SSIM of the first {ORACLE_IMAGES}"
        f" within 1e-5 of the float64 scipy oracle; each metric's float32 value within 1e-5 of the same metric in"
        f" float64 on the card (a batch at a time); {smi}: " + " | ".join(lines)
        + f"; phase {time.perf_counter() - t_phase:.1f} s"
    )
    del preds, target
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# generative evaluation: FID, KID and IS at CIFAR-10 size, LPIPS (12a, 12b)
# ---------------------------------------------------------------------------
CIFAR10_TEST = (10_000, 3, 32, 32)  # CIFAR-10 test split: images, channels, height, width
# reduced (depth, for the script's time limit): 12a and 17a take the first
# 2,000 of CIFAR-10 test's 10,000 images a set
GEN_IMAGES = 2_000
GEN_BATCH = 500
STREAM_CHUNK = 512  # update_stream's chunks: 3 of 512 and a 464-row tail padded to 512
KID_SUBSETS, KID_SUBSET_SIZE = 100, 1000  # KernelInceptionDistance's defaults
IS_SPLITS = 10
GEN_SHIFT, GEN_NOISE = 24.0, 12.0  # the generated set: the real fields' statistics shifted, plus pixel noise
NET_CHECK_IMAGES = 32
# the network's features less their batch mean against float64, relative to the largest of them: a
# float32 forward meets it, a TF32 one misses it (the control below), and so do an input normalized
# as (x - 127.5) / 127.5 and a half-pixel resize (the controls of tests/test_torch_image_networks.py)
NET_CENTRED_RTOL = 5e-3
LPIPS_PAIRS = (1_000, 3, 256, 256)  # image pairs, channels, height, width
LPIPS_BATCH = 50
LPIPS_PERTURB = 0.2  # sigma of the second image's perturbation
LPIPS_CHECK_PAIRS = 16
FID_RTOL = 1e-5  # FID against the scipy oracle on the card's own features
KID_IS_RTOL = 1e-5
STREAM_RTOL = 1e-6


def _smooth_fields(torch, gen, n: int, c: int, h: int, w: int, coarse: int = 4):
    """``[n, c, h, w]`` float32 fields on the card, smooth at ``coarse`` x
    ``coarse`` blocks (bilinear upsampling of seeded normals), about unit scale."""
    import torch.nn.functional as F

    base = torch.randn((n, c, coarse, coarse), generator=gen, device="cuda")
    return F.interpolate(base, size=(h, w), mode="bilinear", align_corners=False)


def _cifar_sets(torch):
    """The real and generated uint8 image sets, made on the card."""
    _, c, h, w = CIFAR10_TEST
    n = GEN_IMAGES
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 12)
    real = (127.5 + 60.0 * _smooth_fields(torch, gen, n, c, h, w)).clamp_(0, 255).round_().to(torch.uint8)
    fake = 127.5 + GEN_SHIFT + 60.0 * _smooth_fields(torch, gen, n, c, h, w)
    fake = (fake + GEN_NOISE * torch.randn(fake.shape, generator=gen, device="cuda")).clamp_(0, 255).round_().to(torch.uint8)
    return real, fake


def _count_conv_macs(torch, forward) -> float:
    """Multiply-adds of one call of ``forward`` in its convolutions, linear
    layers and matmuls, counted from each call's output shape and weight
    shape (run on the CPU, one sample)."""
    import torch.nn.functional as F

    macs = [0.0]
    conv, linear, matmul = F.conv2d, F.linear, torch.matmul

    def conv_count(x, weight, *args, **kwargs):
        out = conv(x, weight, *args, **kwargs)
        macs[0] += out.numel() * weight[0].numel()
        return out

    def linear_count(x, weight, *args, **kwargs):
        out = linear(x, weight, *args, **kwargs)
        macs[0] += out.numel() * weight.shape[1]
        return out

    def matmul_count(a, b, *args, **kwargs):
        out = matmul(a, b, *args, **kwargs)
        macs[0] += out.numel() * a.shape[-1]
        return out

    F.conv2d, F.linear, torch.matmul = conv_count, linear_count, matmul_count
    try:
        forward()
    finally:
        F.conv2d, F.linear, torch.matmul = conv, linear, matmul
    return macs[0]


def _fid_oracle(real: np.ndarray, fake: np.ndarray):
    """FID in float64 numpy with ``scipy.linalg.sqrtm`` of ``S1 S2`` (real
    part): the reference formula, independent of the metric's eigh path.
    Also ``tr S1 + tr S2``, the scale FID is read against, and the
    eigenvalue range of ``S1``."""
    import scipy.linalg

    mu1, mu2 = real.mean(0), fake.mean(0)
    s1, s2 = np.cov(real, rowvar=False), np.cov(fake, rowvar=False)
    covmean = scipy.linalg.sqrtm(s1 @ s2).real
    fid = float(((mu1 - mu2) ** 2).sum() + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean))
    eig = np.linalg.eigvalsh(s1)
    return fid, float(np.trace(s1) + np.trace(s2)), (float(eig[0]), float(eig[-1]))


def _newton_schulz_reference(torch, fid, iters: int) -> float:
    """The JAX package's Newton–Schulz FID (``sharding/linalg.py``), written
    out here in float64 torch on the card from the metric's moment states:
    a check of the port's implementation of that algorithm, apart from how
    far the algorithm itself lands from the eigh value."""

    def moments(prefix: str):
        n = float(getattr(fid, f"{prefix}_n"))
        s = getattr(fid, f"{prefix}_sum") + getattr(fid, f"{prefix}_sum_c")
        outer = getattr(fid, f"{prefix}_outer") + getattr(fid, f"{prefix}_outer_c")
        mu = s / n
        return mu, (outer - n * mu[:, None] * mu[None, :]) / (n - 1)

    def sqrtm(a):
        d = a.shape[0]
        eye = torch.eye(d, dtype=a.dtype, device=a.device)
        a = a + 1e-6 * torch.diagonal(a).sum() / d * eye
        norm = a.pow(2).sum().sqrt()
        y, z = a / norm, eye
        for _ in range(iters):
            t = 0.5 * (3.0 * eye - torch.mm(z, y))
            y, z = torch.mm(y, t), torch.mm(t, z)
        return y * norm.sqrt()

    (mu1, s1), (mu2, s2) = moments("real"), moments("fake")
    half = sqrtm(s1)
    inner = half @ s2 @ half
    covmean = sqrtm(0.5 * (inner + inner.T))
    diff = mu1 - mu2
    return float(diff @ diff + torch.diagonal(s1).sum() + torch.diagonal(s2).sum() - 2 * torch.diagonal(covmean).sum())


def _kid_oracle(real: np.ndarray, fake: np.ndarray, real_idx: np.ndarray, fake_idx: np.ndarray):
    """KID as the JAX package computes it, in float64 numpy: the unbiased
    polynomial MMD (degree 3, gamma 1/d, coef 1) over the given subsets; std ddof 0."""
    d = real.shape[1]
    scores = []
    for r, f in zip(real_idx, fake_idx):
        x, y = real[r], fake[f]
        m = len(r)
        kxx, kyy, kxy = ((x @ x.T) / d + 1) ** 3, ((y @ y.T) / d + 1) ** 3, ((x @ y.T) / d + 1) ** 3
        scores.append((kxx.sum() - np.trace(kxx) + kyy.sum() - np.trace(kyy)) / (m * (m - 1)) - 2 * kxy.sum() / m**2)
    return float(np.mean(scores)), float(np.std(scores, ddof=0))


def _is_oracle(logits: np.ndarray, splits: int, seed: int):
    """Inception Score in float64 numpy: the seeded shuffle, torch.chunk's
    ceil-sized splits, std ddof 1."""
    x = logits[np.random.default_rng(seed).permutation(len(logits))]
    x = x - x.max(1, keepdims=True)
    log_p = x - np.log(np.exp(x).sum(1, keepdims=True))
    p = np.exp(log_p)
    size = -(-len(x) // splits)
    scores = []
    for s in range(0, len(x), size):
        pc, lc = p[s : s + size], log_p[s : s + size]
        scores.append(np.exp((pc * (lc - np.log(pc.mean(0, keepdims=True)))).sum(1).mean()))
    return float(np.mean(scores)), float(np.std(scores, ddof=1))


def _timed_updates(torch, metric, batches, **kwargs):
    """Runs ``metric.update`` over ``batches``; returns (seconds, peak bytes above the start)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    for b in batches:
        metric.update(b, **kwargs)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base


def _timed_compute(torch, metric, repeats: int = 1):
    """``compute()``'s value and its ms, once per repeat (the first pays
    one-time costs: libraries' handles, lazily loaded kernels)."""
    times = []
    for _ in range(repeats):
        metric._computed = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = metric.compute()
        torch.cuda.synchronize()
        times.append(round((time.perf_counter() - t0) * 1e3, 1))
    return value, times if repeats > 1 else times[0]


def _conv_share(rows) -> str:
    total = sum(r["device_us"] for r in rows)
    conv = sum(r["device_us"] for r in rows if any(k in r["name"].lower() for k in CONV_SYMBOLS))
    return f"convolution {conv / max(total, 1e-9):.1%} of device time"


def _forward_note(torch, label: str, steps, images_per_step: int, macs_per_image: float, update_s: float, n_images: int) -> str:
    """Throughput, the profile of a few batches and the multiply-add bound of one path."""
    m = _measure_batches(torch, steps)
    bound_ms = macs_per_image * images_per_step / CUDA_CORE_OPS_PER_S * 1e3
    batch_ms = update_s * 1e3 * images_per_step / n_images
    return (
        f"{label}: {n_images / update_s:.0f} images/s ({batch_ms:.2f} ms per batch of"
        f" {images_per_step}); {_profile_note(m, top=5)}; {_conv_share(m['rows'])}; multiply-add bound"
        f" {bound_ms:.2f} ms per batch ({macs_per_image / 1e9:.3f} GMAC per image at 33.5e12 FMA/s, FP32 without TF32):"
        f" the batch's device busy time (profiled) runs at {bound_ms / max(m['busy_ms'], 1e-9):.1%} of that bound, its"
        f" ms per batch over the stream (not profiled) at {bound_ms / batch_ms:.1%}"
    )


@contextlib.contextmanager
def _tf32_forward(torch, net):
    """The network module's forwards with TF32 on, for cuDNN and cuBLAS: its
    ``full_fp32`` scope swapped for one that turns TF32 on. Not an option of
    the port: the measurement and the control of the float64 check use it."""

    @contextlib.contextmanager
    def tf32():
        cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
        saved = matmul.allow_tf32
        matmul.allow_tf32 = True
        try:
            with cudnn.flags(enabled=True, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic, allow_tf32=True):
                yield
        finally:
            matmul.allow_tf32 = saved

    saved_ctx = net.full_fp32
    net.full_fp32 = tf32
    try:
        yield
    finally:
        net.full_fp32 = saved_ctx


def _centred_err(got, want) -> float:
    """The largest error of the features less their mean over the batch,
    relative to the largest of those: a random-weight network's features
    differ from image to image by about 1e-3 of their size, so this is the
    part that FID's covariances read."""
    g, w = got.double().cpu(), want.double().cpu()
    g, w = g - g.mean(0), w - w.mean(0)
    return float((g - w).abs().max() / w.abs().max())


def _forward_variants(torch, net, ext, imgs) -> str:
    """The open questions of the forward, measured on one batch: the shipped
    full-float32 NCHW forward against the same with TF32 on and against
    channels_last tensors (each by CUDA events, and the features' largest
    relative change against the shipped ones). Neither variant is an option
    of the port."""

    def timed(fn):
        fn()
        return _cuda_ms(torch, fn, iters=5, warmup=1), fn()

    shipped_ms, want = timed(lambda: ext(imgs))
    with _tf32_forward(torch, net):
        tf32_ms, tf32_out = timed(lambda: ext(imgs))
    cl = net.InceptionV3Features(
        {m: {k: (v.contiguous(memory_format=torch.channels_last) if v.ndim == 4 else v) for k, v in g.items()} for m, g in ext.params.items()},
        ext.feature,
    )
    cl_ms, cl_out = timed(lambda: cl(imgs.contiguous(memory_format=torch.channels_last)))

    def rel(a):
        return float((a - want).abs().max() / want.abs().max())

    n = imgs.shape[0]
    return (
        f"forward of {n} images, ms (CUDA events): full float32 NCHW (shipped) {shipped_ms:.2f}, TF32 on {tf32_ms:.2f}"
        f" (features off by {rel(tf32_out):.2e} of the largest, {_centred_err(tf32_out, want):.2e} of the largest centred"
        f" feature), channels_last {cl_ms:.2f} (off by {rel(cl_out):.2e}, centred {_centred_err(cl_out, want):.2e})"
    )


def run_generative_phase(torch, mt, smi: str) -> None:
    """Phase 12a: FID, KID and IS at CIFAR-10 test-set size through the
    InceptionV3 network at full width (seeded random weights), with
    ``update_stream``; the checks run against float64 and numpy/scipy oracles."""
    import concurrent.futures

    from metrics_tpu_torch import engine
    from metrics_tpu_torch.encoders import encoder_stats, reset_encoder_stats
    from metrics_tpu_torch.image.networks import inception as net
    from metrics_tpu_torch.sharding import NEWTON_SCHULZ_FID_RTOL

    t_phase = time.perf_counter()
    n = GEN_IMAGES
    real, fake = _cifar_sets(torch)
    bounds = _batches_of(n, GEN_BATCH)
    real_b = [real[s:e] for s, e in bounds]
    fake_b = [fake[s:e] for s, e in bounds]
    params = net.random_inception_params(seed=SEED, device="cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_inception_")
    path = os.path.join(tmp, "inception.npz")
    net.save_inception_weights(params, path)
    host_params = {m: {k: v.cpu() for k, v in g.items()} for m, g in params.items()}
    macs = _count_conv_macs(torch, lambda: net.InceptionV3Features(host_params, "logits")(torch.zeros(1, 3, 32, 32)))

    # the network: 32 images' features and logits against a float64 copy of the same module on the card
    t_check = time.perf_counter()
    ext = net.resolve_inception_extractor(2048, path)
    ext64 = net.InceptionV3Features({m: {k: v.double() for k, v in g.items()} for m, g in ext.params.items()}, "2048")
    imgs = real[:NET_CHECK_IMAGES]
    logits = net.InceptionV3Features(ext.params, "logits_unbiased")
    logits64 = net.InceptionV3Features(ext64.params, "logits_unbiased")
    centred = {}
    for tap, e32, e64 in (("2048", ext, ext64), ("logits_unbiased", logits, logits64)):
        got, want = e32(imgs), e64(imgs)
        _close(f"inception {tap} (float32) against float64", got, want.cpu().numpy(), rtol=1e-3, atol=2e-3)
        # the features less their batch mean, which the check above cannot see: float32 must meet the
        # bound, and the same forward with TF32 on (the control) must miss it
        with _tf32_forward(torch, net):
            tf32 = e32(imgs)
        centred[tap] = (_centred_err(got, want), _centred_err(tf32, want))
        if not centred[tap][0] <= NET_CENTRED_RTOL:
            raise AssertionError(f"inception {tap} (float32) against float64, centred: {centred[tap][0]:.3e} > {NET_CENTRED_RTOL}")
        if not centred[tap][1] > NET_CENTRED_RTOL:
            raise AssertionError(
                f"inception {tap}: the TF32 control is within {NET_CENTRED_RTOL} of float64 centred ({centred[tap][1]:.3e}):"
                " the check cannot tell a float32 forward from a TF32 one"
            )
    del ext64, logits64
    check_s = time.perf_counter() - t_check

    t0 = _reset_stats(torch, mt)
    fid = mt.FrechetInceptionDistance(feature=2048, weights_path=path)
    kid = mt.KernelInceptionDistance(feature=2048, subsets=KID_SUBSETS, subset_size=KID_SUBSET_SIZE, weights_path=path)
    inception_score = mt.InceptionScore(feature="logits_unbiased", splits=IS_SPLITS, weights_path=path)
    if fid.inception is not kid.inception:
        raise AssertionError("FID and KID of one weights file do not share their extractor")
    fid_real_s, fid_peak = _timed_updates(torch, fid, real_b, real=True)
    fid_fake_s, _ = _timed_updates(torch, fid, fake_b, real=False)
    kid_s, kid_peak = _timed_updates(torch, kid, real_b, real=True)
    kid_s += _timed_updates(torch, kid, fake_b, real=False)[0]
    is_s, _ = _timed_updates(torch, inception_score, fake_b)
    _read_stats(torch, mt, t0, {})
    _log(
        f"generative (12a) updates: FID {2 * n / (fid_real_s + fid_fake_s):.0f} images/s, KID {2 * n / kid_s:.0f}, IS"
        f" {n / is_s:.0f}; the phase so far {time.perf_counter() - t_phase:.1f} s"
    )

    fid_value, fid_compute_ms = _timed_compute(torch, fid)
    kid_value, kid_compute_ms = _timed_compute(torch, kid, repeats=2)
    is_value, is_compute_ms = _timed_compute(torch, inception_score, repeats=2)
    fid_ns = mt.FrechetInceptionDistance(feature=2048, weights_path=path, matrix_sqrt="newton_schulz")
    fid_ns.bind_state({name: getattr(fid, name) for name in fid._defaults}, update_count=fid._update_count)
    ns_value, ns_compute_ms = _timed_compute(torch, fid_ns, repeats=2)
    ns_rel = abs(float(ns_value) - float(fid_value)) / abs(float(fid_value))
    _close("fid Newton-Schulz against the reference iteration in float64", ns_value, _newton_schulz_reference(torch, fid, fid_ns.sqrt_iters), rtol=1e-6)
    real_f = torch.cat(kid.real_features).double().cpu().numpy()
    fake_f = torch.cat(kid.fake_features).double().cpu().numpy()
    want_is = _is_oracle(torch.cat(inception_score.features).double().cpu().numpy(), IS_SPLITS, 42)
    _close("inception score (mean, std) against numpy", torch.stack(is_value), np.array(want_is), rtol=KID_IS_RTOL)

    # update_stream over the real set: one captured encode_acc program, the moments and FID of update
    engine.clear_cache()
    reset_encoder_stats()
    stream_chunks = [real[s:e] for s, e in _batches_of(n, STREAM_CHUNK)]
    fid_s = mt.FrechetInceptionDistance(feature=2048, weights_path=path)
    stream_results = []
    # the first chunk warms up and captures; the others (the 464-row tail padded to 512) replay
    for chunks in (stream_chunks[:1], stream_chunks[1:]):
        t0 = _reset_stats(torch, mt)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        result = fid_s.update_stream(chunks, real=True)
        seconds, _ = _read_stats(torch, mt, t0, {})
        stream_results.append((seconds, torch.cuda.max_memory_allocated() - base, result))
    # another FID of the same extractor replays the same graph
    mt.FrechetInceptionDistance(feature=2048, weights_path=path).update_stream(stream_chunks[:1], real=True)
    summary = engine.cache_summary()["by_kind"].get("encode", {})
    if (summary.get("graphs"), summary.get("compiles"), summary.get("failed_captures")) != (1, 1, 0):
        raise AssertionError(f"update_stream: expected exactly one captured encode_acc program, got {summary}")
    if sum(r.chunks for _, _, r in stream_results) != len(stream_chunks) or sum(r.rows for _, _, r in stream_results) != n:
        raise AssertionError(f"update_stream: {[r for _, _, r in stream_results]}")
    # relative in the max norm: a feature whose sum is near 0 (a channel the ReLUs keep at 0) has no relative digits
    for name in ("real_sum", "real_outer", "real_n"):
        got, want = getattr(fid_s, name).double(), getattr(fid, name).double()
        err = float((got - want).abs().max() / want.abs().max())
        if not err <= STREAM_RTOL:
            raise AssertionError(f"update_stream {name} against update: {err:.3e} of its largest entry (bound {STREAM_RTOL})")
    fid_s.bind_state(
        {name: (getattr(fid, name) if name.startswith("fake") else getattr(fid_s, name)) for name in fid._defaults}
    )
    stream_value, _ = _timed_compute(torch, fid_s)
    # host batches: pinned and copied on the copy stream before each replay, the same moments bit for bit
    staged = [mt.FrechetInceptionDistance(feature=2048, weights_path=path) for _ in range(2)]
    staged[0].update_stream([c.cpu() for c in stream_chunks[:2]], real=True)
    staged[1].update_stream(stream_chunks[:2], real=True)
    if not all(torch.equal(getattr(staged[0], k), getattr(staged[1], k)) for k in ("real_sum", "real_outer", "real_n")):
        raise AssertionError("update_stream: host batches staged to the card give other moments than the same batches on the card")
    if engine.cache_summary()["by_kind"]["encode"]["graphs"] != 1:
        raise AssertionError(f"update_stream: host batches captured another program: {engine.cache_summary()}")
    del staged
    _log(f"generative (12a): update_stream FID {float(stream_value):.9e}, update's {float(fid_value):.9e}")
    _close("update_stream FID against update's", stream_value, float(fid_value), rtol=STREAM_RTOL)
    stream_stats = encoder_stats()

    # profiles of a few warm batches: update (eager forward), and the stream's replays
    update_note = _forward_note(
        torch, "update (FID)", [lambda b=b: fid.update(b, real=True) for b in real_b[:PHASE_PROFILE_BATCHES]],
        GEN_BATCH, macs, fid_real_s + fid_fake_s, 2 * n,
    )
    stream_note = _forward_note(
        torch, "update_stream (replays)", [lambda c=c: fid_s.update_stream([c], real=True) for c in stream_chunks[:PHASE_PROFILE_BATCHES]],
        STREAM_CHUNK, macs, stream_results[1][0], n - STREAM_CHUNK,
    )
    variants_note = _forward_variants(torch, net, fid.inception, real_b[0])
    # the host oracles (scipy's sqrtm, 100 subsets' kernels) run after every timing: run beside them,
    # their BLAS threads slowed the host side of the stream's capture tenfold
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        fid_future = pool.submit(_fid_oracle, real_f, fake_f)
        kid_future = pool.submit(_kid_oracle, real_f, fake_f, *kid.subset_indices(n, n))
        (want_fid, traces, eig_range), want_kid = fid_future.result(), kid_future.result()
    _close("fid (eigh on the host) against the scipy sqrtm oracle", fid_value, want_fid, rtol=FID_RTOL)
    _close("kid (mean, std) against numpy", torch.stack(kid_value), np.array(want_kid), rtol=KID_IS_RTOL)
    if not float(fid_value) > 0.1 * traces:
        raise AssertionError(f"FID {float(fid_value)} of the shifted generated set against tr S1 + tr S2 = {traces}: the sets are not apart")
    # the gap between the Newton-Schulz and eigh values is the algorithm's on this spectrum (its eps
    # shift and its convergence on the smallest eigenvalues), not the port's: the port's iteration is
    # held to the reference iteration above; the gap is logged against the bound, which stays as it is
    ns_note = (
        f"Newton-Schulz {float(ns_value):.9e} (equal to the reference iteration within 1e-6), {ns_rel:.2e} relative to"
        f" eigh: {'within' if ns_rel <= NEWTON_SCHULZ_FID_RTOL else 'OUTSIDE'} the bound {NEWTON_SCHULZ_FID_RTOL}"
        f" (eigenvalues of S1 from {eig_range[0]:.3e} to {eig_range[1]:.3e}, tr S1 + tr S2 = {traces:.6e})"
    )
    shutil.rmtree(tmp, ignore_errors=True)
    _log(
        f"generative (12a): reduced: images a set from CIFAR-10 test's {CIFAR10_TEST[0]} to {n}; {n} real and {n} generated uint8 images of 3 x 32 x 32 (made on the card,"
        f" the generated set shifted by {GEN_SHIFT} and noised at sigma {GEN_NOISE}), batches of {GEN_BATCH}, each resized"
        f" to 299 x 299 by the TF1 matrices, InceptionV3 at full width (seeded random weights, {macs / 1e9:.3f} GMAC per"
        f" image); {smi}; features and logits of {NET_CHECK_IMAGES} images within rtol 1e-3, atol 2e-3 of a float64 copy,"
        f" and less their batch mean within {NET_CENTRED_RTOL} of its largest (float32, TF32 control, by tap: {centred})"
        f" ({check_s:.1f} s); FID {float(fid_value):.9e} within {FID_RTOL} of the scipy sqrtm oracle ({want_fid:.9e}),"
        f" {ns_note}; KID {float(kid_value[0]):.6e} +- {float(kid_value[1]):.6e} ({KID_SUBSETS} subsets of"
        f" {KID_SUBSET_SIZE}) and IS {float(is_value[0]):.9f} +- {float(is_value[1]):.6e} ({IS_SPLITS} splits) within"
        f" {KID_IS_RTOL} of numpy over the same subsets and splits; update_stream's moments and FID within {STREAM_RTOL}"
        f" of update's, one encode_acc program captured ({summary}); host batches staged from pinned memory give the"
        f" same moments bit for bit; encoder_stats {stream_stats}"
    )
    _log(
        f"generative (12a) timings: updates FID {2 * n / (fid_real_s + fid_fake_s):.0f} images/s (peak memory"
        f" {fid_peak / 2**30:.2f} GiB above the start), KID {2 * n / kid_s:.0f} images/s (peak {kid_peak / 2**30:.2f} GiB),"
        f" IS {n / is_s:.0f} images/s; update_stream's first chunk (eager warm-up and capture) {stream_results[0][0]:.2f} s"
        f" (peak {stream_results[0][1] / 2**30:.2f} GiB above the start), then replays {(n - STREAM_CHUNK) / stream_results[1][0]:.0f}"
        f" images/s (peak {stream_results[1][1] / 2**30:.2f} GiB); compute() first and warm, ms: FID eigh on the host"
        f" {fid_compute_ms}, Newton-Schulz on the card {ns_compute_ms}, KID {kid_compute_ms}, IS {is_compute_ms}"
    )
    _log(f"generative (12a) {update_note}")
    _log(f"generative (12a) {variants_note}")
    _log(f"generative (12a) {stream_note}")
    _log(f"generative (12a): phase {time.perf_counter() - t_phase:.1f} s, oracles and data included")
    del fid, kid, inception_score, fid_ns, fid_s, real, fake, real_b, fake_b, stream_chunks
    engine.clear_cache()
    torch.cuda.empty_cache()


def _lpips_pairs(torch):
    n, c, h, w = LPIPS_PAIRS
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 13)
    img1 = (0.6 * _smooth_fields(torch, gen, n, c, h, w, coarse=16)).clamp_(-1, 1)
    img2 = (img1 + LPIPS_PERTURB * torch.randn(img1.shape, generator=gen, device="cuda")).clamp_(-1, 1)
    return img1, img2


def run_lpips_phase(torch, mt, smi: str) -> None:
    """Phase 12b: LPIPS over 1,000 pairs of 256 x 256 images, AlexNet and VGG16."""
    from metrics_tpu_torch.image.networks import lpips as net

    t_phase = time.perf_counter()
    img1, img2 = _lpips_pairs(torch)
    bounds = _batches_of(LPIPS_PAIRS[0], LPIPS_BATCH)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lpips_")
    lines = []
    for name in ("alex", "vgg"):
        path = os.path.join(tmp, f"{name}.npz")
        host_params = net.random_lpips_params(name, seed=SEED, device="cpu")
        net.save_lpips_weights(host_params, path)
        host_net = net.LPIPSNetwork(host_params, name)
        # per image: the pair's two images run as one batch
        macs = _count_conv_macs(torch, lambda: host_net(torch.zeros(1, 3, 256, 256), torch.zeros(1, 3, 256, 256))) / 2
        t0 = _reset_stats(torch, mt)
        metric = mt.LearnedPerceptualImagePatchSimilarity(net=name, weights_path=path)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        for s, e in bounds:
            metric.update(img1[s:e], img2[s:e])
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated() - base
        _read_stats(torch, mt, t0, {})
        value, compute_ms = _timed_compute(torch, metric)
        network = metric.net
        per_pair = torch.cat([network(img1[s:e], img2[s:e]) for s, e in bounds])
        _close(f"lpips {name}: the streamed mean against the per-pair mean", value, float(per_pair.double().mean()), rtol=1e-6)
        k = LPIPS_CHECK_PAIRS
        net64 = net.LPIPSNetwork({m: {p: v.double() for p, v in g.items()} for m, g in network.params.items()}, name)
        _close(f"lpips {name}: {k} pairs (float32) against float64", per_pair[:k], net64(img1[:k], img2[:k]).cpu().numpy(), rtol=1e-4, atol=1e-5)
        _close(f"lpips {name}: identical pairs", network(img1[:k], img1[:k]), np.zeros(k), atol=1e-6)
        note = _forward_note(
            torch, f"{name} update", [lambda s=s, e=e: metric.update(img1[s:e], img2[s:e]) for s, e in bounds[:PHASE_PROFILE_BATCHES]],
            2 * LPIPS_BATCH, macs, update_s, 2 * LPIPS_PAIRS[0],
        )
        lines.append(
            f"{name}: LPIPS {float(value):.6f}, {LPIPS_PAIRS[0] / update_s:.0f} pairs/s, compute() {compute_ms:.2f} ms,"
            f" peak memory {peak / 2**30:.2f} GiB above the start; {note}"
        )
        del metric, network, net64, per_pair
        torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    _log(
        f"lpips (12b): {LPIPS_PAIRS[0]} pairs of 3 x 256 x 256 images in [-1, 1] (made on the card, the second the first plus"
        f" a perturbation of sigma {LPIPS_PERTURB}), batches of {LPIPS_BATCH} pairs, seeded random weights; the streamed"
        f" mean within 1e-6 of the per-pair mean, {LPIPS_CHECK_PAIRS} pairs within rtol 1e-4, atol 1e-5 of a float64"
        f" copy, identical pairs 0 within 1e-6; {smi}: " + " | ".join(lines)
        + f"; phase {time.perf_counter() - t_phase:.1f} s"
    )
    del img1, img2
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 13: the text metrics and BERTScore
# ---------------------------------------------------------------------------
TEXT_VOCAB = 30_000  # a Zipf-distributed word list
TEXT_ZIPF = (1.0, 2.7)  # Zipf-Mandelbrot exponent and shift of the word ranks
WMT14_NEWSTEST = 3_003  # WMT14 newstest2014 en-de: segments, one reference each
MT_SEGMENTS = 500  # reduced (depth, for the script's time limit): 13a (and 13e, 17a) stream 500 segments
MT_WORDS = 25  # mean words per segment (Poisson)
MT_BATCH = 64
MT_EDITS = (0.12, 0.05, 0.05)  # word substitution, drop and insertion rates of a hypothesis
LIBRISPEECH_TEST_CLEAN = 2_620  # utterances
ASR_UTTERANCES = 1_000  # reduced (depth, for the script's time limit): 13b streams 1,000 utterances
ASR_WORDS = 20
ASR_EDITS = (0.03, 0.01, 0.01)  # about 5% word errors
CNNDM_TEST = 11_490  # CNN/DailyMail 3.0.0 test: summaries of 3-4 sentences, about 56 words
SUM_SUMMARIES = 4_000  # reduced (depth, for the script's time limit): 13c streams 4,000 summaries
SUM_BATCH = 32
SQUAD_DEV = 10_570  # SQuAD v1.1 dev: questions
QA_BATCH = 512
QA_UNANSWERED = 0.02
TEXT_PREFIX = 500  # pairs of the CPU-functional prefix checks
TEXT_ATOL = 1e-6  # the JAX text tests' atol (tests/text/helpers.py)
TEXT_PHASE_BUDGET_S = 180.0
ROUGE_CUT = 2_000  # summaries ROUGE takes if the phase would pass its budget
# BERTScore's user encoder at roberta-large width, cut to bert-score's default layer
BERT_VOCAB, BERT_DIM, BERT_HEADS, BERT_FFN, BERT_POSITIONS, BERT_LAYERS = 50_265, 1024, 16, 4096, 514, 17
BERT_MAX_LEN = 512
BERT_BATCH = 64
BERT_ORACLE_PAIRS = 64
BERT_MACS_PER_TOKEN_LAYER = 4 * BERT_DIM * BERT_DIM + 2 * BERT_DIM * BERT_FFN  # 12.6M: q, k, v, out and the FFN
BERT_BASELINE = ((0.30, 0.32, 0.31), (0.84, 0.85, 0.845))  # the seeded baseline CSV's rows (P, R, F1)


class _Vocab:
    """A Zipf-distributed vocabulary of lowercase letter strings (most
    frequent first) and a seeded stream of words drawn from it, sampled in
    bulk."""

    def __init__(self, rng, size: int = TEXT_VOCAB) -> None:
        letters = np.array(list("etaoinshrdlcumwfgypbvkjxqz"))
        freq = 1.0 / np.arange(1, 27) ** 0.8
        words, seen = [], set()
        while len(words) < size:
            w = "".join(rng.choice(letters, int(rng.integers(2, 10)), p=freq / freq.sum()))
            if w not in seen:
                seen.add(w)
                words.append(w)
        ranks = np.arange(size, dtype=np.float64)
        p = 1.0 / (ranks + TEXT_ZIPF[1]) ** TEXT_ZIPF[0]
        self.words, self.p, self.rng = np.array(words), p / p.sum(), rng
        self._pool: list = []
        self._at = 0

    def draw(self, k: int) -> list:
        if self._at + k > len(self._pool):
            self._pool = self._pool[self._at :] + self.words[self.rng.choice(len(self.words), 1 << 20, p=self.p)].tolist()
            self._at = 0
        self._at += k
        return self._pool[self._at - k : self._at]


def _perturbed(rng, ref: list, vocab: "_Vocab", edits, reverse: bool = True) -> list:
    """A hypothesis: the reference with seeded substitutions, drops and
    insertions, and (with ``reverse``) one 3-word span reversed."""
    sub, drop, ins = edits
    out = []
    for w in ref:
        r = rng.random()
        if r < sub:
            out.extend(vocab.draw(1))
        elif r >= sub + drop:
            out.append(w)
        if rng.random() < ins:
            out.extend(vocab.draw(1))
    if reverse and len(out) >= 3:
        i = int(rng.integers(0, len(out) - 2))
        out[i : i + 3] = out[i : i + 3][::-1]
    return out


def _text_pairs(rng, vocab: "_Vocab", n: int, mean_words: int, edits, punctuate: bool):
    """``n`` (hypothesis, reference) strings; with ``punctuate`` (translation)
    the first word is capitalized, some words carry a comma, the sentence ends
    in a full stop and the hypothesis has a reversed 3-word span; without
    (transcripts) it has only word errors."""
    preds, refs = [], []
    for k in np.maximum(1, rng.poisson(mean_words, n)):
        ref = vocab.draw(int(k))
        hyp = _perturbed(rng, ref, vocab, edits, reverse=punctuate)
        if punctuate:
            ref, hyp = (_punctuate(rng, s) for s in (ref, hyp))
        refs.append(" ".join(ref))
        preds.append(" ".join(hyp))
    return preds, refs


def _punctuate(rng, ws: list) -> list:
    if not ws:
        return ws
    ws = [w + "," if rng.random() < 0.06 else w for w in ws]
    ws[0] = ws[0].capitalize()
    ws[-1] = ws[-1].rstrip(",") + "."
    return ws


def _ngram_counts(tokens: list, n: int) -> dict:
    out: dict = {}
    for i in range(len(tokens) - n + 1):
        key = tuple(tokens[i : i + n])
        out[key] = out.get(key, 0) + 1
    return out


def _bleu_oracle(preds: list, refs: list, tokenize, n_gram: int = 4):
    """BLEU's counters (clipped n-gram matches, n-gram totals, lengths) and
    its score, one reference per segment, in float64."""
    num, den = np.zeros(n_gram), np.zeros(n_gram)
    p_len = t_len = 0
    for hyp, ref in zip(preds, refs):
        h, r = tokenize(hyp), tokenize(ref)
        p_len += len(h)
        t_len += len(r)
        for n in range(1, n_gram + 1):
            hc, rc = _ngram_counts(h, n), _ngram_counts(r, n)
            num[n - 1] += sum(min(c, rc.get(g, 0)) for g, c in hc.items())
            den[n - 1] += sum(hc.values())
    score = 0.0
    if num.min() > 0:
        bp = 1.0 if p_len > t_len else np.exp(1 - t_len / p_len)
        score = bp * np.exp(np.mean(np.log(num / den)))
    return num, den, p_len, t_len, score


def _levenshtein(a, b) -> int:
    """Edit distance with unit costs in plain Python: Myers' bit-parallel
    algorithm (Hyyrö's formulation) on Python integers, a column of the DP
    per token of ``b``; another algorithm than the port's numpy row-DP."""
    if not a or not b:
        return len(a) or len(b)
    peq: dict = {}
    for i, x in enumerate(a):
        peq[x] = peq.get(x, 0) | (1 << i)
    full, top = (1 << len(a)) - 1, 1 << (len(a) - 1)
    pv, mv, score = full, 0, len(a)
    for y in b:
        eq = peq.get(y, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = (mv | ~(xh | pv)) & full
        mh = pv & xh
        score += 1 if ph & top else -1 if mh & top else 0
        ph = ((ph << 1) | 1) & full
        mh = (mh << 1) & full
        pv = (mh | ~(xv | ph)) & full
        mv = ph & xv
    return score


def _rouge_n_oracle(preds: list, refs: list, n: int):
    """Mean per-summary ROUGE-N F, precision and recall: clipped n-gram overlap
    of the lowercased alphanumeric tokens."""
    import re

    rows = []
    for hyp, ref in zip(preds, refs):
        h, r = (_ngram_counts(re.sub(r"[^a-z0-9]+", " ", s.lower()).split(), n) for s in (hyp, ref))
        hits = sum(min(c, r.get(g, 0)) for g, c in h.items())
        hn, rn = sum(h.values()), sum(r.values())
        prec, rec = (hits / hn, hits / rn) if hn and rn else (0.0, 0.0)
        rows.append((2 * prec * rec / (prec + rec) if prec + rec else 0.0, prec, rec))
    return np.mean(rows, axis=0)


def _squad_normalize(s: str) -> list:
    import re
    import string

    s = "".join(ch for ch in s.lower() if ch not in set(string.punctuation))
    return re.sub(r"\b(a|an|the)\b", " ", s).split()


def _squad_oracle(preds: dict, targets: list):
    """Sums of exact match and token F1 (best over ground truths) and the count."""
    em = f1 = 0.0
    for t in targets:
        if t["id"] not in preds:
            continue
        p = _squad_normalize(preds[t["id"]])
        best_em = best_f1 = 0.0
        for truth in t["answers"]["text"]:
            g = _squad_normalize(truth)
            best_em = max(best_em, float(p == g))
            common = sum(min(p.count(w), g.count(w)) for w in set(p))
            if not p or not g:
                score = float(p == g)
            elif common == 0:
                score = 0.0
            else:
                prec, rec = common / len(p), common / len(g)
                score = 2 * prec * rec / (prec + rec)
            best_f1 = max(best_f1, score)
        em += best_em
        f1 += best_f1
    return em, f1, len(targets)


def _squad_corpus(rng, vocab: "_Vocab"):
    """SQuAD v1.1 dev-size questions in its JSON layout: 1-3 ground truths of
    1-4 words, predictions exact, overlapping or wrong, 2% unanswered."""
    preds, targets = [], []
    for q in range(SQUAD_DEV):
        qid = f"q{q:05d}"
        truths = [" ".join(vocab.draw(int(rng.integers(1, 5)))) for _ in range(int(rng.integers(1, 4)))]
        targets.append({"answers": {"answer_start": [0] * len(truths), "text": truths}, "id": qid})
        if rng.random() < QA_UNANSWERED:
            continue
        r = rng.random()
        if r < 0.55:
            answer = truths[0] if rng.random() < 0.5 else "The " + truths[-1].upper() + "."
        elif r < 0.85:
            answer = " ".join(_perturbed(rng, truths[0].split(), vocab, (0.3, 0.1, 0.3)))
        else:
            answer = " ".join(vocab.draw(3))
        preds.append({"prediction_text": answer, "id": qid})
    return preds, targets


def _h2d_copies(torch, fn) -> int:
    """Host-to-device copies ``fn`` makes, counted at the torch calls: a
    tensor moved or copied from the CPU to the card, or made on the card
    from host data. (The profiler's memcpy events miss some small pageable
    copies.)"""
    from torch.overrides import TorchFunctionMode

    moves, made = {"to", "cuda", "copy_"}, {"tensor", "as_tensor"}
    count = [0]

    class _Count(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = getattr(func, "__name__", "")
            if name in moves and len(args) >= 1:
                src, dst = (args[1], args[0]) if name == "copy_" else (args[0], out)
                moved = isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
                count[0] += moved and src.device.type == "cpu" and dst.device.type == "cuda"
            elif name in made and isinstance(out, torch.Tensor) and out.device.type == "cuda":
                count[0] += not (args and isinstance(args[0], torch.Tensor) and args[0].device.type == "cuda")
            return out

    with _Count():
        fn()
    return count[0]


def _text_update_note(torch, label: str, make, batches, stream_s: float, n_updates: int) -> str:
    """ms per update on the host clock over the stream, then three warm
    updates of a fresh instance: profiled (device ms, busy share, host
    syncs) and counted (host-to-device copies per update)."""
    metric = make()
    metric.update(*batches[0])
    steps = [lambda b=b: metric.update(*b) for b in batches[1 : 1 + PHASE_PROFILE_BATCHES]]
    m = _measure_batches(torch, steps)
    copies = sum(_h2d_copies(torch, step) for step in steps) / len(steps)
    device = (
        f"{m['device_ms']:.4f} ms device (profiled: {m['wall_ms']:.2f} ms wall, busy share {m['busy_ms'] / m['wall_ms']:.4f}"
        if m["rows"] else f"device time not measured, no device event in the profile ({m['wall_ms']:.2f} ms wall"
    )
    return (
        f"{label}: {stream_s * 1e3 / n_updates:.2f} ms per update on the host clock over the stream, {device},"
        f" {m['syncs']} host syncs, {copies:g} host-to-device copies per update)"
    )


def _stream_text(torch, make, batches):
    """``forward`` on the first batch, ``update`` on the rest, ``compute()``:
    (metric, first-batch value, stream seconds, compute value, compute ms, peak bytes)."""
    metric = make()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    first = metric(*batches[0])
    for b in batches[1:]:
        metric.update(*b)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    value, compute_ms = _timed_compute(torch, metric)
    return metric, first, stream_s, value, compute_ms, torch.cuda.max_memory_allocated() - base


def _on_card(name: str, value) -> None:
    values = value.values() if isinstance(value, dict) else (value if isinstance(value, tuple) else (value,))
    for v in values:
        if v.device.type != "cuda":
            raise AssertionError(f"{name}: a value on {v.device}, not on the card")


def _text_close(name: str, got, want, atol: float = TEXT_ATOL) -> None:
    if isinstance(want, dict):
        for k in want:
            _text_close(f"{name}[{k}]", got[k], want[k], atol)
        return
    if isinstance(want, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            _text_close(f"{name}[{i}]", g, w, atol)
        return
    _close(name, got, np.asarray(want.cpu().numpy() if hasattr(want, "cpu") else want, dtype=np.float64), atol=atol)


def _text_sub_phase(torch, mt, label: str, metrics: dict, batches, prefix_batches, prefix_fns: dict) -> list:
    """Streams each metric of ``metrics`` (name -> (maker, functional)), holds
    its first batch's ``forward`` to the functional on that batch, and, for
    the names in ``prefix_fns``, a second instance over the prefix batches to
    the functional on the CPU; returns (name, value, note) rows."""
    rows = []
    for name, (make, functional) in metrics.items():
        t0 = _reset_stats(torch, mt)
        metric, first, stream_s, value, compute_ms, peak = _stream_text(torch, make, batches)
        _read_stats(torch, mt, t0, {})
        _on_card(f"{label} {name}", value)
        _text_close(f"{label} {name}: the first batch's forward against the functional", first, functional(*batches[0]))
        if name in prefix_fns:
            prefix = make()
            for b in prefix_batches:
                prefix.update(*b)
            flat = [sum((list(b[i]) for b in prefix_batches), []) for i in range(2)]
            _text_close(f"{label} {name}: {TEXT_PREFIX} pairs on the card against the functional on the CPU", prefix.compute(), prefix_fns[name](*flat))
        note = _text_update_note(torch, name, make, batches, stream_s, len(batches))
        rows.append((name, metric, value, f"{note}; compute() {compute_ms:.2f} ms; peak {peak / 2**20:.2f} MiB above the start"))
    return rows


def _batched(xs, size: int) -> list:
    return [xs[s : s + size] for s in range(0, len(xs), size)]


def _round(v) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{k}: {float(x):.6f}" for k, x in v.items()) + "}"
    if isinstance(v, tuple):
        return f"{float(v[0]):.6f} (and {v[1].numel()} sentence scores)"
    return f"{float(v):.6f}"


def run_translation(torch, mt, ft, vocab, rng) -> list:
    """13a: machine translation at WMT14 newstest2014 (en-de) size."""
    import re

    preds, refs = _text_pairs(rng, vocab, MT_SEGMENTS, MT_WORDS, MT_EDITS, punctuate=True)
    targets = [[r] for r in refs]
    batches = list(zip(_batched(preds, MT_BATCH), _batched(targets, MT_BATCH)))
    prefix_batches = list(zip(_batched(preds[:TEXT_PREFIX], MT_BATCH), _batched(targets[:TEXT_PREFIX], MT_BATCH)))
    cpu = {"device": "cpu"}
    metrics = {
        "BLEUScore": (lambda: mt.BLEUScore(), lambda a, b: ft.bleu_score(a, b)),
        "SacreBLEUScore(13a)": (lambda: mt.SacreBLEUScore(tokenize="13a"), lambda a, b: ft.sacre_bleu_score(a, b, tokenize="13a")),
        "CHRFScore(chrF++)": (lambda: mt.CHRFScore(n_word_order=2), lambda a, b: ft.chrf_score(a, b, n_word_order=2)),
        "TranslationEditRate": (lambda: mt.TranslationEditRate(), lambda a, b: ft.translation_edit_rate(a, b)),
        "ExtendedEditDistance": (lambda: mt.ExtendedEditDistance(), lambda a, b: ft.extended_edit_distance(a, b)),
    }
    prefix_fns = {
        "CHRFScore(chrF++)": lambda a, b: ft.chrf_score(a, b, n_word_order=2, **cpu),
        "TranslationEditRate": lambda a, b: ft.translation_edit_rate(a, b, **cpu),
        "ExtendedEditDistance": lambda a, b: ft.extended_edit_distance(a, b, **cpu),
    }
    rows = _text_sub_phase(torch, mt, "translation (13a)", metrics, batches, prefix_batches, prefix_fns)
    # BLEU and SacreBLEU-13a against the clipped n-gram oracle (the corpus's only punctuation is "," and ".")
    for name, tokenize in (("BLEUScore", str.split), ("SacreBLEUScore(13a)", lambda s: re.findall(r"[A-Za-z]+|[.,]", s))):
        metric = next(m for n, m, _, _ in rows if n == name)
        num, den, p_len, t_len, score = _bleu_oracle(preds, refs, tokenize)
        for state, want in (("numerator", num), ("denominator", den), ("preds_len", p_len), ("target_len", t_len)):
            _close(f"translation (13a) {name} {state}", getattr(metric, state), np.asarray(want, dtype=np.float64))
        _close(f"translation (13a) {name} score", metric.compute(), score, atol=TEXT_ATOL)
    return rows, len(batches), preds, refs


def run_speech(torch, mt, ft, vocab, rng) -> list:
    """13b: speech recognition on LibriSpeech test-clean-like utterances."""
    preds, refs = _text_pairs(rng, vocab, ASR_UTTERANCES, ASR_WORDS, ASR_EDITS, punctuate=False)
    batches = list(zip(_batched(preds, MT_BATCH), _batched(refs, MT_BATCH)))
    metrics = {
        name: (lambda cls=cls: getattr(mt, cls)(), lambda a, b, fn=fn: getattr(ft, fn)(a, b))
        for name, cls, fn in (
            ("WordErrorRate", "WordErrorRate", "word_error_rate"),
            ("CharErrorRate", "CharErrorRate", "char_error_rate"),
            ("MatchErrorRate", "MatchErrorRate", "match_error_rate"),
            ("WordInfoLost", "WordInfoLost", "word_information_lost"),
            ("WordInfoPreserved", "WordInfoPreserved", "word_information_preserved"),
        )
    }
    rows = _text_sub_phase(torch, mt, "speech (13b)", metrics, batches, [], {})
    # plain Python Levenshtein: counts exact, scores within 1e-6
    w_err = sum(_levenshtein(h.split(), r.split()) for h, r in zip(preds, refs))
    c_err = sum(_levenshtein(h, r) for h, r in zip(preds, refs))
    n_ref = sum(len(r.split()) for r in refs)
    n_hyp = sum(len(h.split()) for h in preds)
    n_max = sum(max(len(h.split()), len(r.split())) for h, r in zip(preds, refs))
    hits = n_max - w_err
    want = {
        "WordErrorRate": ({"errors": w_err, "total": n_ref}, w_err / n_ref),
        "CharErrorRate": ({"errors": c_err, "total": sum(map(len, refs))}, c_err / sum(map(len, refs))),
        "MatchErrorRate": ({"errors": w_err, "total": n_max}, w_err / n_max),
        "WordInfoLost": ({"hits": hits, "target_total": n_ref, "preds_total": n_hyp}, 1 - hits / n_ref * hits / n_hyp),
        "WordInfoPreserved": ({"hits": hits, "target_total": n_ref, "preds_total": n_hyp}, hits / n_ref * hits / n_hyp),
    }
    for name, metric, value, _ in rows:
        counts, score = want[name]
        for state, v in counts.items():
            _close(f"speech (13b) {name} {state}", getattr(metric, state), float(v))
        _close(f"speech (13b) {name} score", value, score, atol=TEXT_ATOL)
    return rows, len(batches)


def run_summarization(torch, mt, ft, vocab, rng, n: int) -> list:
    """13c: summarization at CNN/DailyMail 3.0.0 test size (or its first ``n``)."""
    preds, refs = [], []
    for _ in range(n):
        k = int(rng.integers(3, 5))  # sentences
        lengths = np.maximum(3, rng.poisson(56 / k, k))
        ref_s = [_punctuate(rng, vocab.draw(int(m))) for m in lengths]
        hyp_s = [_punctuate(rng, _perturbed(rng, [w.rstrip(",.").lower() for w in s], vocab, MT_EDITS)) for s in ref_s]
        refs.append(" ".join(" ".join(s) for s in ref_s))
        preds.append(" ".join(" ".join(s) for s in hyp_s if s))
    batches = list(zip(_batched(preds, SUM_BATCH), _batched(refs, SUM_BATCH)))
    keys = ("rouge1", "rouge2", "rougeL", "rougeLsum")
    prefix_batches = list(zip(_batched(preds[:TEXT_PREFIX], SUM_BATCH), _batched(refs[:TEXT_PREFIX], SUM_BATCH)))
    metrics = {"ROUGEScore": (lambda: mt.ROUGEScore(rouge_keys=keys, accumulate="best"), lambda a, b: ft.rouge_score(a, b, rouge_keys=keys))}
    prefix_fns = {"ROUGEScore": lambda a, b: ft.rouge_score(a, b, rouge_keys=keys, device="cpu")}
    rows = _text_sub_phase(torch, mt, "summarization (13c)", metrics, batches, prefix_batches, prefix_fns)
    value = rows[0][2]
    for n_gram in (1, 2):
        f, prec, rec = _rouge_n_oracle(preds, refs, n_gram)
        for stat, want in (("fmeasure", f), ("precision", prec), ("recall", rec)):
            _close(f"summarization (13c) rouge{n_gram}_{stat}", value[f"rouge{n_gram}_{stat}"], want, atol=TEXT_ATOL)
    return rows, len(batches)


def run_question_answering(torch, mt, ft, vocab, rng) -> list:
    """13d: extractive QA at SQuAD v1.1 dev size."""
    from metrics_tpu_torch.obs.warn import reset_warn_once

    preds, targets = _squad_corpus(rng, vocab)
    by_id = {q["id"]: q for q in preds}
    t_batches = _batched(targets, QA_BATCH)
    batches = [([by_id[t["id"]] for t in tb if t["id"] in by_id], tb) for tb in t_batches]
    reset_warn_once("squad_unanswered_question")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rows = _text_sub_phase(torch, mt, "question answering (13d)", {"SQuAD": (lambda: mt.SQuAD(), lambda a, b: ft.squad(a, b))}, batches, [], {})
    unanswered = [w for w in caught if "Unanswered question" in str(w.message)]
    if len(unanswered) != 1:
        raise AssertionError(f"question answering (13d): {len(unanswered)} unanswered-question warnings, expected one")
    metric, value = rows[0][1], rows[0][2]
    em, f1, total = _squad_oracle({q["id"]: q["prediction_text"] for q in preds}, targets)
    _close("question answering (13d) exact-match sum", metric.exact_match, em, atol=1e-3)
    _close("question answering (13d) F1 sum", metric.f1_score, f1, atol=1e-2)
    if metric.total.dtype != torch.int64 or int(metric.total) != total:
        raise AssertionError(f"question answering (13d): total {metric.total} ({metric.total.dtype}), expected {total} int64")
    _close("question answering (13d) exact_match", value["exact_match"], 100 * em / total, atol=100 * TEXT_ATOL)
    _close("question answering (13d) f1", value["f1"], 100 * f1 / total, atol=100 * TEXT_ATOL)
    return rows, len(batches), SQUAD_DEV - len(preds)


def _bert_params(torch, seed: int, layers: int = BERT_LAYERS) -> dict:
    """The seeded weights of :func:`_bert_encoder`, drawn in its order (so
    the first ``layers`` layers of a cut encoder are the full one's)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def w(*shape, scale=0.02):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    d = BERT_DIM
    return {
        "tok": w(BERT_VOCAB, d), "pos": w(BERT_POSITIONS, d),
        "ln0": (torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")),
        "layers": [
            {
                "qkv": (w(3 * d, d), w(3 * d, scale=0.0)), "out": (w(d, d), w(d, scale=0.0)),
                "ln1": (torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")),
                "ff1": (w(BERT_FFN, d), w(BERT_FFN, scale=0.0)), "ff2": (w(d, BERT_FFN), w(d, scale=0.0)),
                "ln2": (torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")),
            }
            for _ in range(layers)
        ],
    }


def _bert_apply(params, input_ids, attention_mask):
    """The encoder's forward as ``apply_fn(params, ids, mask)``."""
    import torch.nn.functional as F

    d, h = BERT_DIM, BERT_HEADS
    n, length = input_ids.shape
    x = params["tok"][input_ids] + params["pos"][:length][None]
    x = F.layer_norm(x, (d,), *params["ln0"])
    bias = ((1.0 - attention_mask.to(x.dtype)) * -1e9)[:, None, None, :]
    for layer in params["layers"]:
        q, k, v = F.linear(x, *layer["qkv"]).view(n, length, 3, h, d // h).permute(2, 0, 3, 1, 4)
        a = F.scaled_dot_product_attention(q, k, v, attn_mask=bias).transpose(1, 2).reshape(n, length, d)
        x = F.layer_norm(x + F.linear(a, *layer["out"]), (d,), *layer["ln1"])
        x = F.layer_norm(x + F.linear(F.gelu(F.linear(x, *layer["ff1"])), *layer["ff2"]), (d,), *layer["ln2"])
    return x


def _bert_encoder(torch, seed: int):
    """A post-LayerNorm transformer encoder at roberta-large width (vocabulary
    50,265, d = 1024, 16 heads, FFN 4096, 514 positions), cut to 17 layers,
    float32, seeded random weights. Attention is ``scaled_dot_product_attention``
    with an additive key mask (a large negative number, not -inf, so an
    all-pad row stays finite): no nested-tensor fast path, so the forward
    captures, and padding does not change the valid positions."""
    params = _bert_params(torch, seed)

    def forward(input_ids, attention_mask):
        return _bert_apply(params, input_ids, attention_mask)

    return forward


def _bert_tokenizer(text, max_length):
    """The own-tokenizer contract: a CRC32 hash of each word into the
    vocabulary, between [CLS] (0) and [SEP] (2); padding id 1."""
    import zlib

    ids = np.ones((len(text), max_length), np.int64)
    mask = np.zeros((len(text), max_length), np.int64)
    for i, s in enumerate(text):
        toks = [0] + [zlib.crc32(w.encode()) % (BERT_VOCAB - 3) + 3 for w in s.split()][: max_length - 2] + [2]
        ids[i, : len(toks)] = toks
        mask[i, : len(toks)] = 1
    return {"input_ids": ids, "attention_mask": mask}


def _bert_oracle(emb_p: np.ndarray, emb_t: np.ndarray, tok_p: dict, tok_t: dict, idf: dict, default: float):
    """Float64 idf-weighted greedy cosine matching of each pair, [CLS] and
    the last attended token left out (``tests/text/test_bert.py``'s oracle)."""
    out = []
    for i in range(len(emb_p)):
        sides = []
        for emb, tok in ((emb_p, tok_p), (emb_t, tok_t)):
            keep = np.flatnonzero(tok["attention_mask"][i])[1:-1]
            e = emb[i][keep].astype(np.float64)
            sides.append((e / np.linalg.norm(e, axis=-1, keepdims=True), np.array([idf.get(int(t), default) for t in tok["input_ids"][i][keep]])))
        (p, wp), (t, wt) = sides
        sim = p @ t.T
        prec, rec = (sim.max(1) * wp).sum() / wp.sum(), (sim.max(0) * wt).sum() / wt.sum()
        out.append((prec, rec, 2 * prec * rec / (prec + rec)))
    return np.array(out)


def _bert_chunks(tok: dict) -> list:
    """The ``(rows, width)`` of each pow2-bucketed encoder chunk of one side."""
    from metrics_tpu_torch.engine.bucketing import next_pow2

    out = []
    for s in range(0, len(tok["input_ids"]), BERT_BATCH):
        mask = tok["attention_mask"][s : s + BERT_BATCH]
        rows = mask.shape[0] if mask.shape[0] >= BERT_BATCH else next_pow2(mask.shape[0])
        out.append((rows, min(BERT_MAX_LEN, next_pow2(int(np.flatnonzero(mask.any(0))[-1]) + 1))))
    return out


def run_bert_score(torch, mt, ft, preds: list, refs: list, smi: str) -> str:
    """13e: BERTScore at full width on 13a's pairs, four routes."""
    from metrics_tpu_torch.encoders import ShardedEncoder, encoder_stats, reset_encoder_stats
    from metrics_tpu_torch.engine import cache as engine_cache
    from metrics_tpu_torch.functional.text.bert import _get_precision_recall_f1
    from metrics_tpu_torch.image.networks._common import full_fp32

    t_phase = time.perf_counter()
    forward = _bert_encoder(torch, SEED)

    def encoder(input_ids, attention_mask):
        with torch.no_grad(), full_fp32():
            return forward(input_ids, attention_mask)

    n = len(preds)
    kw = {"user_tokenizer": _bert_tokenizer, "idf": True, "max_length": BERT_MAX_LEN, "batch_size": BERT_BATCH}
    tok_p, tok_t = _bert_tokenizer(preds, BERT_MAX_LEN), _bert_tokenizer(refs, BERT_MAX_LEN)
    attended = [tok["attention_mask"].sum(1) for tok in (tok_p, tok_t)]
    chunks_p, chunks_t = _bert_chunks(tok_p), _bert_chunks(tok_t)
    signatures = set(chunks_p + chunks_t)
    encoded_tokens = sum(rows * width for rows, width in chunks_p + chunks_t)

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base

    reset_encoder_stats()
    plain, plain_s, plain_peak = timed(lambda: ft.bert_score(preds, refs, model=encoder, **kw))
    buckets = encoder_stats()["bucketed_dispatches"]
    if buckets <= 0:
        raise AssertionError("bert score (13e): no pow2-bucketed encoder dispatch")

    def streamed():
        metric = mt.BERTScore(model=encoder, **kw)
        for s in range(0, n, BERT_BATCH):
            metric.update(preds[s : s + BERT_BATCH], refs[s : s + BERT_BATCH])
        return metric.compute()

    module, module_s, module_peak = timed(streamed)
    probe = mt.BERTScore(model=encoder, **kw)
    module_copies = _h2d_copies(torch, lambda: probe.update(preds[:BERT_BATCH], refs[:BERT_BATCH]))
    engine_cache.clear_cache()
    enc = ShardedEncoder.from_callable(encoder, name="roberta_large_17")

    def sharded_stream():
        metric = mt.BERTScore(encoder_sharding=enc, **kw)
        for s in range(0, n, BERT_BATCH):
            metric.update(preds[s : s + BERT_BATCH], refs[s : s + BERT_BATCH])
        return metric.compute()

    sharded, sharded_s, _ = timed(sharded_stream)
    captures = engine_cache.encoder_entry(enc).summary()
    if captures["compiles"] != len(signatures) or captures["graphs"] != len(signatures):
        raise AssertionError(f"bert score (13e): {captures} captures for {len(signatures)} (rows, width) signatures")
    unbucketed, unbucketed_s, unbucketed_peak = timed(lambda: ft.bert_score(preds, refs, model=encoder, length_bucketing=False, **kw))
    for key in ("precision", "recall", "f1"):
        _close(f"bert score (13e) module against the functional, {key}", np.asarray(module[key]), np.asarray(plain[key]), atol=1e-6)
        _close(f"bert score (13e) ShardedEncoder route against the plain route, {key}", np.asarray(sharded[key]), np.asarray(plain[key]), atol=1e-5)
        _close(f"bert score (13e) bucketing off against on, {key}", np.asarray(unbucketed[key]), np.asarray(plain[key]), atol=1e-5)

    # the first 64 pairs against float64 numpy on the card's own embeddings (the chunk the functional encoded)
    k = BERT_ORACLE_PAIRS
    idf_counts: dict = {}
    for ids, mask in zip(tok_t["input_ids"], tok_t["attention_mask"]):
        for t in set(ids[mask.astype(bool)].tolist()):
            idf_counts[t] = idf_counts.get(t, 0) + 1
    idf = {t: np.log((n + 1) / (c + 1)) for t, c in idf_counts.items()}
    embs = []
    for tok, (_, width) in ((tok_p, chunks_p[0]), (tok_t, chunks_t[0])):
        ids = torch.from_numpy(tok["input_ids"][:k, :width]).cuda()
        mask = torch.from_numpy(tok["attention_mask"][:k, :width]).cuda()
        embs.append(encoder(ids, mask).cpu().numpy())
    oracle = _bert_oracle(embs[0], embs[1], {kk: v[:k] for kk, v in tok_p.items()}, {kk: v[:k] for kk, v in tok_t.items()}, idf, np.log(n + 1))
    for col, key in enumerate(("precision", "recall", "f1")):
        _close(f"bert score (13e) first {k} pairs against float64, {key}", np.asarray(plain[key][:k]), oracle[:, col], atol=1e-5)

    # rescale with a seeded baseline CSV: (s - b) / (1 - b) with the last row
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bert_")
    path = os.path.join(tmp, "baseline.csv")
    with open(path, "w") as f:
        f.write("LAYER,P,R,F\n" + "".join(f"{i},{a},{b},{c}\n" for i, (a, b, c) in enumerate(BERT_BASELINE)))
    small = ft.bert_score(preds[:k], refs[:k], model=encoder, rescale_with_baseline=True, baseline_path=path, **kw)
    raw = ft.bert_score(preds[:k], refs[:k], model=encoder, **kw)
    shutil.rmtree(tmp, ignore_errors=True)
    for col, key in enumerate(("precision", "recall", "f1")):
        b = BERT_BASELINE[-1][col]
        _close(f"bert score (13e) rescale, {key}", np.asarray(small[key]), (np.asarray(raw[key]) - b) / (1 - b), atol=1e-6)

    # one chunk's encoder and matching on the device clock, and the profile of a few chunks
    s0, p_w, t_w = slice(0, BERT_BATCH), chunks_p[0][1], chunks_t[0][1]
    ids_p, m_p = (torch.from_numpy(tok_p[key][s0, :p_w]).cuda() for key in ("input_ids", "attention_mask"))
    ids_t, m_t = (torch.from_numpy(tok_t[key][s0, :t_w]).cuda() for key in ("input_ids", "attention_mask"))
    e_p, e_t = encoder(ids_p, m_p), encoder(ids_t, m_t)
    encode_ms = _device_ms(torch, lambda: (encoder(ids_p, m_p), encoder(ids_t, m_t)))
    match_ms = _device_ms(torch, lambda: _get_precision_recall_f1(e_p, e_t, m_p.float(), m_t.float(), torch.ones_like(m_p, dtype=torch.float32), torch.ones_like(m_t, dtype=torch.float32)))
    prof = _measure_batches(torch, [lambda s=s: ft.bert_score(preds[s : s + BERT_BATCH], refs[s : s + BERT_BATCH], model=encoder, **kw) for s in range(0, PHASE_PROFILE_BATCHES * BERT_BATCH, BERT_BATCH)])
    tokens = int(sum(a.sum() for a in attended))
    attention_macs = sum(2 * int((a.astype(np.int64) ** 2).sum()) * BERT_DIM for a in attended) * BERT_LAYERS
    macs = tokens * BERT_LAYERS * BERT_MACS_PER_TOKEN_LAYER + attention_macs
    bound_s = macs / CUDA_CORE_OPS_PER_S
    return (
        f"bert score (13e): {n} pairs of 13a, own-model contract (CRC32 word hashes), a seeded {BERT_LAYERS}-layer encoder"
        f" at roberta-large width (d {BERT_DIM}, {BERT_HEADS} heads, FFN {BERT_FFN}, vocabulary {BERT_VOCAB}), float32 with"
        f" TF32 off, idf, max_length {BERT_MAX_LEN}, batches of {BERT_BATCH}; {smi}: functional {n / plain_s:.0f} pairs/s"
        f" ({plain_s:.2f} s, peak {plain_peak / 2**30:.2f} GiB), module streamed {n / module_s:.0f} pairs/s ({module_s:.2f} s,"
        f" peak {module_peak / 2**30:.2f} GiB, {module_copies} host-to-device copies an update), ShardedEncoder {n / sharded_s:.0f} pairs/s ({sharded_s:.2f} s;"
        f" {captures['compiles']} captured encode programs for {len(signatures)} (rows, width) signatures,"
        f" {captures['cache_hits']} replays), bucketing off {n / unbucketed_s:.0f} pairs/s ({unbucketed_s:.2f} s, peak"
        f" {unbucketed_peak / 2**30:.2f} GiB); {buckets} bucketed dispatches; mean F1 {np.mean(plain['f1']):.6f}; checks: first"
        f" {k} pairs within 1e-5 of float64, module within 1e-6 and the ShardedEncoder and unbucketed routes within 1e-5 of"
        f" the functional, rescale exact; one chunk of {BERT_BATCH} pairs (widths {p_w} and {t_w}): encoder {encode_ms:.3f} ms"
        f" device, matching {match_ms:.3f} ms device; {_profile_note(prof, top=5)}; multiply-add bound {bound_s * 1e3:.1f} ms"
        f" ({tokens} attended tokens of {encoded_tokens} encoded, {macs / 1e12:.2f} T MAC with attention, at 33.5e12 FMA/s),"
        f" {bound_s / plain_s:.1%} of the functional's time; phase {time.perf_counter() - t_phase:.1f} s"
    )


def run_text_phase(torch, mt, smi: str):
    """Phase 13: the text metrics at the sizes of their test sets, and
    BERTScore; returns 13a's pairs, which 13e scores."""
    import metrics_tpu_torch.functional as ft

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    vocab = _Vocab(rng)
    mt_rows, mt_updates, mt_preds, mt_refs = run_translation(torch, mt, ft, vocab, rng)
    _log(f"translation (13a): reduced: segments from WMT14 newstest2014 en-de's {WMT14_NEWSTEST} to {MT_SEGMENTS}; batches of {MT_BATCH} ({mt_updates} updates); {smi}: " + " | ".join(f"{name} {_round(v)}; {note}" for name, _, v, note in mt_rows))
    asr_rows, asr_updates = run_speech(torch, mt, ft, vocab, rng)
    _log(f"speech (13b): reduced: utterances from LibriSpeech test-clean's {LIBRISPEECH_TEST_CLEAN} to {ASR_UTTERANCES}; batches of {MT_BATCH} ({asr_updates} updates); {smi}: " + " | ".join(f"{name} {_round(v)}; {note}" for name, _, v, note in asr_rows))
    n_sum = SUM_SUMMARIES
    sum_rows, sum_updates = run_summarization(torch, mt, ft, vocab, rng, n_sum)
    _log(f"summarization (13c): reduced: summaries from CNN/DailyMail 3.0.0 test's {CNNDM_TEST} to {n_sum}; batches of {SUM_BATCH} ({sum_updates} updates); {smi}: " + " | ".join(f"{name} {_round(v)}; {note}" for name, _, v, note in sum_rows))
    qa_rows, qa_updates, unanswered = run_question_answering(torch, mt, ft, vocab, rng)
    _log(f"question answering (13d): {SQUAD_DEV} questions (SQuAD v1.1 dev size, {unanswered} unanswered, warned once), batches of {QA_BATCH} ({qa_updates} updates); {smi}: " + " | ".join(f"{name} {_round(v)}; {note}" for name, _, v, note in qa_rows))
    _log(run_bert_score(torch, mt, ft, mt_preds, mt_refs, smi))
    torch.cuda.empty_cache()
    _log(f"phase 13: {time.perf_counter() - t_phase:.1f} s in all, oracles and data included")
    return mt_preds, mt_refs


# ---------------------------------------------------------------------------
# phase 14: audio and detection
# ---------------------------------------------------------------------------
LIBRI2MIX_TEST = 3_000  # Libri2Mix test set (8 kHz, "min"): mixtures of 2 speakers
SEP_FS, SEP_SAMPLES = 8_000, 32_000  # every utterance cut to 4 s (the real ones vary)
SEP_BATCH = 16
SEP_FIR_TAPS = 16
SEP_FILTER_LENGTH = 512
SEP_LEVELS = {"fir": (-2.5, -0.7), "leak": (-1.8, -0.4), "noise": (-1.8, -0.4)}  # log10 ranges, relative to the source
DNS_TEST = 150  # DNS Challenge (Interspeech 2020) synthetic no-reverb test set: clips
DNS_FS, DNS_SAMPLES = 16_000, 160_000  # 10 s at 16 kHz
DNS_BATCH = 10
DNS_SNR_DB = (0.0, 25.0)
AUDIO_ORACLE = (64, 20)  # mixtures of 14a and clips of 14b held to the float64 oracles
AUDIO_DB_ATOL = 1e-4
SDR_DB_ATOL, SDR_ORACLE_MAX_DB = 1e-3, 25.0  # float32 SDR within 1e-3 dB where the oracle is at most 25 dB
STOI_ATOL = 2e-4  # the JAX suite's float32 STOI tolerance (tests/audio/test_stoi.py)
RESAMPLE_ATOL = 1e-4
STREAM_MEAN_RTOL = 1e-5
COCO_VAL2017 = (5_000, 80, 36_781)  # images, classes, ground-truth boxes
MAP_IMAGES = 1_500  # reduced (depth, for the script's time limit): 14c's images, the ground truths in proportion
COCO_IMAGE = (640.0, 480.0)
COCO_AREAS = ((0.41, 4.0**2, 32.0**2), (0.34, 32.0**2, 96.0**2), (0.24, 96.0**2, 350.0**2))  # COCO's split: share, area range
COCO_TOP_CLASS = 0.3  # share of the most frequent class (person in COCO)
COCO_DETECTIONS = 100  # per image, Detectron's cap
COCO_COPIES = 1.3  # detections that copy a ground truth, per ground truth
MAP_BATCH = 16
MAP_ORACLE_IMAGES = 200
MAP_ORACLE_ATOL = 1e-6


def _speech_like(torch, gen, n: int, samples: int, fs: int):
    """``[n, samples]`` band-structured modulated noise on the card, the
    speech stand-in of ``tests/audio/test_stoi.py``, each signal with its own
    seeded syllable rate (2-6 Hz), carrier (100-400 Hz) and phase."""
    def draw(lo, hi):
        return lo + (hi - lo) * torch.rand(n, 1, generator=gen, device="cuda")

    t = torch.arange(samples, device="cuda", dtype=torch.float32) / fs
    env = 0.5 + 0.5 * torch.sin(2 * np.pi * draw(2.0, 6.0) * t + draw(0.0, 2 * np.pi))
    return env * (torch.randn(n, samples, generator=gen, device="cuda") + 0.3 * torch.sin(2 * np.pi * draw(100.0, 400.0) * t))


def _log_uniform(torch, gen, n: int, lo: float, hi: float):
    return 10 ** (lo + (hi - lo) * torch.rand(n, 1, generator=gen, device="cuda"))


def _rms(torch, x):
    return torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True))


def _separation_data(torch, ft):
    """Libri2Mix-sized separation stream: sources ``[N, 2, T]`` and estimates,
    each estimate a source in a seeded speaker order through a seeded 16-tap
    FIR, plus leakage of the other source and noise at seeded levels; and
    the estimates aligned by PIT, batch by batch."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    n, spk, t = LIBRI2MIX_TEST, 2, SEP_SAMPLES
    sources = _speech_like(torch, gen, n * spk, t, SEP_FS).reshape(n, spk, t)
    order = torch.rand(n, spk, generator=gen, device="cuda").argsort(dim=1)
    permuted = torch.take_along_dim(sources, order[..., None], dim=1).reshape(n * spk, t)
    taps = _log_uniform(torch, gen, n * spk, *SEP_LEVELS["fir"]) * torch.randn(n * spk, SEP_FIR_TAPS, generator=gen, device="cuda")
    taps[:, 0] = 1.0
    filtered = torch.nn.functional.conv1d(
        torch.nn.functional.pad(permuted, (SEP_FIR_TAPS - 1, 0))[None], taps.flip(-1)[:, None, :], groups=n * spk
    )[0]
    other = permuted.reshape(n, spk, t).flip(1).reshape(n * spk, t)
    rms = _rms(torch, permuted)
    estimates = (
        filtered
        + _log_uniform(torch, gen, n * spk, *SEP_LEVELS["leak"]) * other
        + _log_uniform(torch, gen, n * spk, *SEP_LEVELS["noise"]) * rms * torch.randn(n * spk, t, generator=gen, device="cuda")
    ).reshape(n, spk, t)
    del permuted, filtered, other
    bounds = [(s, min(s + SEP_BATCH, n)) for s in range(0, n, SEP_BATCH)]
    raw = [(estimates[s:e], sources[s:e]) for s, e in bounds]
    aligned = []
    for est, src in raw:
        _, perm = ft.permutation_invariant_training(est, src, ft.scale_invariant_signal_noise_ratio)
        aligned.append((ft.pit_permutate(est, perm), src))
    torch.cuda.synchronize()
    return raw, aligned


def _dns_data(torch):
    """DNS-Challenge-sized enhancement stream: clean speech-like clips and
    noisy copies at seeded SNRs from 0 to 25 dB, batches ``[10, 160000]``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    clean = _speech_like(torch, gen, DNS_TEST, DNS_SAMPLES, DNS_FS)
    noise = torch.randn(DNS_TEST, DNS_SAMPLES, generator=gen, device="cuda")
    snr_db = DNS_SNR_DB[0] + (DNS_SNR_DB[1] - DNS_SNR_DB[0]) * torch.rand(DNS_TEST, 1, generator=gen, device="cuda")
    noisy = clean + noise * (_rms(torch, clean) / _rms(torch, noise)) * 10 ** (-snr_db / 20)
    return [(noisy[s : s + DNS_BATCH], clean[s : s + DNS_BATCH]) for s in range(0, DNS_TEST, DNS_BATCH)]


def _per_sample(torch, fn, batches):
    """``fn`` on every batch: its values as float64 numpy, one vector per batch."""
    return [fn(*b).double().cpu().numpy().reshape(-1) for b in batches]


def _snr_oracles(p: np.ndarray, t: np.ndarray):
    """Closed forms in float64 over the last axis: SNR, SI-SDR, SI-SNR."""
    eps32 = np.finfo(np.float32).eps

    def si_sdr(p, t):
        alpha = (np.sum(p * t, -1, keepdims=True) + eps32) / (np.sum(t * t, -1, keepdims=True) + eps32)
        ts = alpha * t
        return 10 * np.log10((np.sum(ts * ts, -1) + eps32) / (np.sum((ts - p) ** 2, -1) + eps32))

    snr = 10 * np.log10((np.sum(t * t, -1) + eps32) / (np.sum((t - p) ** 2, -1) + eps32))
    centred = (p - p.mean(-1, keepdims=True), t - t.mean(-1, keepdims=True))
    return {"snr": snr, "si_sdr": si_sdr(p, t), "si_snr": si_sdr(*centred)}


def _sdr_oracle(p: np.ndarray, t: np.ndarray, filter_length: int) -> np.ndarray:
    """Filter-invariant SDR in float64 with a Levinson solve of the Toeplitz
    system (``scipy.linalg.solve_toeplitz``), one signal at a time."""
    from scipy.linalg import solve_toeplitz

    out = []
    for pi, ti in zip(p.reshape(-1, p.shape[-1]), t.reshape(-1, t.shape[-1])):
        pi, ti = pi / np.linalg.norm(pi), ti / np.linalg.norm(ti)
        n_fft = 1 << int(np.ceil(np.log2(2 * len(ti))))
        tf, pf = np.fft.rfft(ti, n_fft), np.fft.rfft(pi, n_fft)
        acf = np.fft.irfft(np.abs(tf) ** 2, n_fft)[:filter_length]
        xcorr = np.fft.irfft(np.conj(tf) * pf, n_fft)[:filter_length]
        coh = xcorr @ solve_toeplitz(acf, xcorr)
        out.append(10 * np.log10(coh / (1 - coh)))
    return np.asarray(out)


def _pit_oracle(est: np.ndarray, src: np.ndarray):
    """Brute force over both speaker orders: best mean SI-SNR and its permutation."""
    from itertools import permutations

    perms = list(permutations(range(src.shape[1])))
    scores = np.stack([np.mean([_snr_oracles(est[:, p[j]], src[:, j])["si_snr"] for j in range(len(p))], axis=0) for p in perms], 1)
    best = scores.argmax(1)
    return scores[np.arange(len(best)), best], np.asarray(perms)[best]


def _stream_audio(torch, mt, label: str, metrics: dict, batches, per_sample: dict, require_programs) -> list:
    """Streams each metric of ``metrics`` (name -> maker): ``forward`` on
    the first batch (held to the per-sample values of that batch), ``update``
    on the rest, ``compute()`` (held to the mean of every per-sample value);
    no repo kernel launches; returns (name, value, note) rows."""
    rows = []
    for name, make in metrics.items():
        values = per_sample[name.split(" ")[0]]
        t0 = _reset_stats(torch, mt)
        metric, first, stream_s, value, compute_ms, peak = _stream_text(torch, make, batches)
        _read_stats(torch, mt, t0, {})
        _on_card(f"{label} {name}", value)
        _close(f"{label} {name}: the first batch's forward against its per-sample values", first, values[0].mean(), atol=AUDIO_DB_ATOL)
        _close(f"{label} {name}: the streamed mean against the mean of the per-sample values", value, np.concatenate(values).mean(), rtol=STREAM_MEAN_RTOL)
        if name in require_programs:
            _require_programs(f"{label} {name}", metric)
        note = _text_update_note(torch, name, make, batches, stream_s, len(batches))
        rows.append((name, value, f"{note}; compute() {compute_ms:.2f} ms; peak {peak / 2**20:.1f} MiB above the start; {_engine_note(metric)}"))
    return rows


def _audio_oracle_checks(torch, ft, label: str, est, src, fs: int, values: dict, sdr: bool) -> str:
    """The first mixtures or clips against float64 numpy: the SNR family's
    closed forms, SDR (where asked) against ``solve_toeplitz``, STOI and
    ESTOI against ``tests/helpers/stoi_oracle.py``; returns a note."""
    from tests.helpers.stoi_oracle import stoi_oracle

    p, t = est.double().cpu().numpy(), src.double().cpu().numpy()
    n = p.reshape(-1, p.shape[-1]).shape[0]
    for key, want in _snr_oracles(p, t).items():
        if key in values:
            _close(f"{label} {key}: the first {n} signals against the float64 closed form", values[key][:n], want.reshape(-1), atol=AUDIO_DB_ATOL)
    note = ""
    if sdr:
        want = _sdr_oracle(p, t, SEP_FILTER_LENGTH)
        low = want <= SDR_ORACLE_MAX_DB
        err = np.abs(values["sdr"][:n] - want)
        _close(f"{label} sdr: the first {n} signals at most {SDR_ORACLE_MAX_DB:g} dB against solve_toeplitz", values["sdr"][:n][low], want[low], atol=SDR_DB_ATOL)
        note += (
            f"SDR against solve_toeplitz: max error {err[low].max():.2e} dB over {int(low.sum())} signals at most {SDR_ORACLE_MAX_DB:g} dB,"
            f" {err[~low].max() if (~low).any() else 0.0:.2e} dB over {int((~low).sum())} above (oracle {want.min():.1f} to {want.max():.1f} dB); "
        )
    for key, extended in (("stoi", False), ("estoi", True)):
        want = np.asarray([stoi_oracle(ti, pi, fs, extended) for pi, ti in zip(p.reshape(n, -1), t.reshape(n, -1))])
        _close(f"{label} {key}: the first {n} signals against the numpy oracle", values[key][:n], want, atol=STOI_ATOL)
        note += f"{key.upper()} max error {np.abs(values[key][:n] - want).max():.2e} against the oracle; "
    return note


def _resampler_check(torch, x, fs: int) -> float:
    """The port's resampler on the card against ``scipy.signal.resample_poly``
    with the Octave Kaiser filter; the max abs error."""
    from metrics_tpu_torch.functional.audio.stoi import _resample
    from tests.helpers.stoi_oracle import resample_oct

    got = _resample(x, fs).cpu().numpy()
    want = np.stack([resample_oct(row, 10000, fs) for row in x.double().cpu().numpy()])
    _close(f"resampler at {fs} Hz against resample_poly", got, want, atol=RESAMPLE_ATOL)
    return float(np.abs(got - want).max())


def run_separation(torch, mt, ft, smi: str) -> str:
    """14a: Libri2Mix test size, 8 kHz, 2 speakers: PIT, then the aligned estimates."""
    t_sub = time.perf_counter()
    raw, aligned = _separation_data(torch, ft)
    data_s = time.perf_counter() - t_sub
    fns = {
        "pit": lambda e, s: ft.permutation_invariant_training(e, s, ft.scale_invariant_signal_noise_ratio)[0],
        "si_sdr": ft.scale_invariant_signal_distortion_ratio,
        "si_snr": ft.scale_invariant_signal_noise_ratio,
        "snr": ft.signal_noise_ratio,
        "sdr": lambda e, s: ft.signal_distortion_ratio(e, s, filter_length=SEP_FILTER_LENGTH),
        "stoi": lambda e, s: ft.short_time_objective_intelligibility(e, s, SEP_FS),
        "estoi": lambda e, s: ft.short_time_objective_intelligibility(e, s, SEP_FS, extended=True),
    }
    per_sample = {k: _per_sample(torch, fn, raw if k == "pit" else aligned) for k, fn in fns.items()}
    values = {k: np.concatenate(v) for k, v in per_sample.items()}
    rows = _stream_audio(torch, mt, "separation (14a)", {"pit": lambda: mt.PermutationInvariantTraining(ft.scale_invariant_signal_noise_ratio)}, raw, per_sample, {"pit"})
    rows += _stream_audio(
        torch, mt, "separation (14a)",
        {
            "si_sdr": lambda: mt.ScaleInvariantSignalDistortionRatio(),
            "si_snr": lambda: mt.ScaleInvariantSignalNoiseRatio(),
            "snr": lambda: mt.SignalNoiseRatio(),
            "sdr": lambda: mt.SignalDistortionRatio(filter_length=SEP_FILTER_LENGTH),
            "stoi": lambda: mt.ShortTimeObjectiveIntelligibility(SEP_FS),
            "stoi (jit_update=True)": lambda: mt.ShortTimeObjectiveIntelligibility(SEP_FS, jit_update=True),
            "estoi": lambda: mt.ShortTimeObjectiveIntelligibility(SEP_FS, extended=True),
        },
        # SDR's batched LU (MAGMA at this shape) refuses capture: its update falls back to eager, logged
        aligned, per_sample, {"si_sdr", "si_snr", "snr", "stoi (jit_update=True)"},
    )
    t_oracle = time.perf_counter()
    m = AUDIO_ORACLE[0]
    est = torch.cat([b[0] for b in raw])[:m].double().cpu().numpy()
    src = torch.cat([b[1] for b in raw])[:m].double().cpu().numpy()
    best, perm = _pit_oracle(est, src)
    got_best, got_perm = ft.permutation_invariant_training(
        torch.cat([b[0] for b in raw])[:m], torch.cat([b[1] for b in raw])[:m], ft.scale_invariant_signal_noise_ratio
    )
    if not np.array_equal(got_perm.cpu().numpy(), perm):
        raise AssertionError("separation (14a) pit: permutations differ from the brute force")
    _close(f"separation (14a) pit: the first {m} mixtures against the brute force", got_best, best, atol=AUDIO_DB_ATOL)
    est_a = torch.cat([b[0] for b in aligned])[:m]
    src_a = torch.cat([b[1] for b in aligned])[:m]
    note = _audio_oracle_checks(torch, ft, "separation (14a)", est_a, src_a, SEP_FS, values, sdr=True)
    resample_err = _resampler_check(torch, src_a[:2].reshape(-1, SEP_SAMPLES), SEP_FS)
    n_batches = len(raw)
    spread = {k: (float(v.min()), float(v.max())) for k, v in values.items() if k in ("si_sdr", "sdr")}
    return (
        f"separation (14a): {LIBRI2MIX_TEST} mixtures of 2 speakers (Libri2Mix test size, 8 kHz; reduced: every utterance"
        f" {SEP_SAMPLES / SEP_FS:g} s), batches of {SEP_BATCH} ({n_batches} updates); data {data_s:.1f} s; per-signal range"
        f" SI-SDR {spread['si_sdr'][0]:.1f} to {spread['si_sdr'][1]:.1f} dB, SDR {spread['sdr'][0]:.1f} to {spread['sdr'][1]:.1f} dB; {smi}: "
        + " | ".join(f"{name} {float(v):.6f}; {n}" for name, v, n in rows)
        + f" || oracles on the first {m} mixtures ({time.perf_counter() - t_oracle:.1f} s): PIT permutations equal the brute force; {note}"
        f"resampler at 8 kHz max error {resample_err:.2e}"
    )


def run_enhancement(torch, mt, ft, smi: str) -> str:
    """14b: DNS Challenge synthetic no-reverb test size, 16 kHz: SNR, SI-SDR,
    STOI and ESTOI on the 875-tap resampler path; the PESQ gate."""
    t_sub = time.perf_counter()
    batches = _dns_data(torch)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t_sub
    fns = {
        "snr": ft.signal_noise_ratio,
        "si_sdr": ft.scale_invariant_signal_distortion_ratio,
        "stoi": lambda p, t: ft.short_time_objective_intelligibility(p, t, DNS_FS),
        "estoi": lambda p, t: ft.short_time_objective_intelligibility(p, t, DNS_FS, extended=True),
    }
    per_sample = {k: _per_sample(torch, fn, batches) for k, fn in fns.items()}
    values = {k: np.concatenate(v) for k, v in per_sample.items()}
    rows = _stream_audio(
        torch, mt, "enhancement (14b)",
        {
            "snr": lambda: mt.SignalNoiseRatio(),
            "si_sdr": lambda: mt.ScaleInvariantSignalDistortionRatio(),
            "stoi": lambda: mt.ShortTimeObjectiveIntelligibility(DNS_FS),
            "estoi": lambda: mt.ShortTimeObjectiveIntelligibility(DNS_FS, extended=True),
        },
        batches, per_sample, {"snr", "si_sdr"},
    )
    try:
        mt.PerceptualEvaluationSpeechQuality(DNS_FS, "wb")
        raise AssertionError("enhancement (14b): PESQ constructed without the pesq wheel")
    except ModuleNotFoundError as err:
        gate = str(err)
    t_oracle = time.perf_counter()
    m = AUDIO_ORACLE[1]
    noisy, clean = torch.cat([b[0] for b in batches])[:m], torch.cat([b[1] for b in batches])[:m]
    note = _audio_oracle_checks(torch, ft, "enhancement (14b)", noisy, clean, DNS_FS, values, sdr=False)
    resample_err = _resampler_check(torch, clean[:2], DNS_FS)
    return (
        f"enhancement (14b): {DNS_TEST} clips of {DNS_SAMPLES / DNS_FS:g} s at 16 kHz (DNS Challenge 2020 synthetic no-reverb"
        f" test size), SNR {DNS_SNR_DB[0]:g}-{DNS_SNR_DB[1]:g} dB, batches of {DNS_BATCH} ({len(batches)} updates); data {data_s:.1f} s; {smi}: "
        + " | ".join(f"{name} {float(v):.6f}; {n}" for name, v, n in rows)
        + f" || oracles on the first {m} clips ({time.perf_counter() - t_oracle:.1f} s): {note}resampler at 16 kHz max error"
        f" {resample_err:.2e} || PESQ gated: {gate}"
    )


def _coco_data(torch):
    """COCO val2017-like detections on the card: ground truths at val2017's
    density over ``MAP_IMAGES`` images (about Poisson, mean 7.36 an image), COCO's area split, one
    class at 30%; 100 detections an image: jittered copies of the ground
    truths (1.3 a ground truth, 90% with the right label) and seeded false
    positives, with seeded scores. Returns the flat tensors and the
    per-image counts."""
    rng = np.random.default_rng(SEED + 14)
    n_img, n_cls = MAP_IMAGES, COCO_VAL2017[1]
    n_gt = round(COCO_VAL2017[2] * n_img / COCO_VAL2017[0])
    gt_counts = np.bincount(rng.integers(0, n_img, n_gt), minlength=n_img)
    gt_off = np.concatenate([[0], np.cumsum(gt_counts)[:-1]])
    j = np.arange(COCO_DETECTIONS)[None, :]
    copies = j < np.minimum(COCO_DETECTIONS, np.round(COCO_COPIES * gt_counts))[:, None]
    src = np.where(copies, gt_off[:, None] + j % np.maximum(gt_counts, 1)[:, None], 0).reshape(-1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device="cuda", dtype=torch.float64)

    def labels(n):
        top = rand(n) < COCO_TOP_CLASS
        return torch.where(top, 0, torch.randint(1, n_cls, (n,), generator=gen, device="cuda"))

    def boxes(n):
        shares = torch.tensor([s for s, _, _ in COCO_AREAS], device="cuda", dtype=torch.float64)
        kind = torch.multinomial(shares, n, replacement=True, generator=gen)
        lo = torch.log(torch.tensor([a for _, a, _ in COCO_AREAS], device="cuda", dtype=torch.float64))[kind]
        hi = torch.log(torch.tensor([b for _, _, b in COCO_AREAS], device="cuda", dtype=torch.float64))[kind]
        area = torch.exp(lo + (hi - lo) * rand(n))
        aspect = torch.exp(np.log(0.5) + np.log(4.0) * rand(n))
        w = torch.sqrt(area * aspect).clamp(max=COCO_IMAGE[0])
        h = torch.sqrt(area / aspect).clamp(max=COCO_IMAGE[1])
        x, y = (COCO_IMAGE[0] - w) * rand(n), (COCO_IMAGE[1] - h) * rand(n)
        return torch.stack([x, y, x + w, y + h], dim=1)

    gt_boxes, gt_labels = boxes(n_gt), labels(n_gt)
    n_det = n_img * COCO_DETECTIONS
    copy = torch.from_numpy(copies.reshape(-1)).cuda()
    src_t = torch.from_numpy(src).cuda()
    base = gt_boxes[src_t]
    size = (base[:, 2:] - base[:, :2]).repeat(1, 2)
    jittered = base + 0.08 * size * torch.randn(n_det, 4, generator=gen, device="cuda", dtype=torch.float64)
    x1, x2 = torch.minimum(jittered[:, 0], jittered[:, 2]), torch.maximum(jittered[:, 0], jittered[:, 2]) + 1
    y1, y2 = torch.minimum(jittered[:, 1], jittered[:, 3]), torch.maximum(jittered[:, 1], jittered[:, 3]) + 1
    det_boxes = torch.where(copy[:, None], torch.stack([x1, y1, x2, y2], 1), boxes(n_det))
    det_labels = torch.where(copy & (rand(n_det) < 0.9), gt_labels[src_t], labels(n_det))
    det_scores = torch.sigmoid(torch.where(copy, 1.0, -1.0) + torch.randn(n_det, generator=gen, device="cuda", dtype=torch.float64))
    flat = {
        "det_boxes": det_boxes.float(), "det_scores": det_scores.float(), "det_labels": det_labels,
        "gt_boxes": gt_boxes.float(), "gt_labels": gt_labels,
    }
    return flat, gt_counts.tolist(), [COCO_DETECTIONS] * n_img


def _coco_images(torch, flat, gt_counts, det_counts, device: str):
    """Per-image (preds, target) dicts of views into the flat tensors on ``device``."""
    f = {k: v.to(device) for k, v in flat.items()}
    split = {k: torch.split(v, det_counts if k.startswith("det") else gt_counts) for k, v in f.items()}
    preds = [{"boxes": b, "scores": s, "labels": l} for b, s, l in zip(split["det_boxes"], split["det_scores"], split["det_labels"])]
    targets = [{"boxes": b, "labels": l} for b, l in zip(split["gt_boxes"], split["gt_labels"])]
    return preds, targets


def run_detection(torch, mt, smi: str) -> str:
    """14c: COCO val2017-like: ``MAP_IMAGES`` images, 80 classes, 100 detections an
    image, batches of 16, ``class_metrics=True``: the card's result against a
    CPU instance's bit for bit, the first 200 images against the numpy COCO
    oracle; ``update`` makes no host sync."""
    from tests.helpers.coco_oracle import coco_eval

    t_sub = time.perf_counter()
    flat, gt_counts, det_counts = _coco_data(torch)
    preds, targets = _coco_images(torch, flat, gt_counts, det_counts, "cuda")
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t_sub
    n_img = len(preds)
    bounds = [(s, min(s + MAP_BATCH, n_img)) for s in range(0, n_img, MAP_BATCH)]
    t0 = _reset_stats(torch, mt)
    card = mt.MeanAveragePrecision(class_metrics=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t_stream = time.perf_counter()
    for s, e in bounds:
        card.update(preds[s:e], targets[s:e])
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t_stream
    value, compute_ms = _timed_compute(torch, card)
    peak = torch.cuda.max_memory_allocated() - base
    _read_stats(torch, mt, t0, {})
    _on_card("detection (14c) map", value)
    probe = mt.MeanAveragePrecision(class_metrics=True)
    syncs = _host_syncs(torch, lambda: probe.update(preds[:MAP_BATCH], targets[:MAP_BATCH]))
    copies = _h2d_copies(torch, lambda: probe.update(preds[:MAP_BATCH], targets[:MAP_BATCH]))
    if syncs or copies:
        raise AssertionError(f"detection (14c): an update made {syncs} host syncs and {copies} host-to-device copies")
    note = _text_update_note(
        torch, "update", lambda: mt.MeanAveragePrecision(class_metrics=True),
        [(preds[s:e], targets[s:e]) for s, e in bounds[:1 + PHASE_PROFILE_BATCHES]], stream_s, len(bounds),
    )
    state_bytes = sum(x.numel() * x.element_size() for name in ("detection_boxes", "detection_scores", "detection_labels", "groundtruth_boxes", "groundtruth_labels") for x in getattr(card, name))

    t_cpu = time.perf_counter()
    cpu_preds, cpu_targets = _coco_images(torch, flat, gt_counts, det_counts, "cpu")
    cpu = mt.MeanAveragePrecision(class_metrics=True, device="cpu")
    for s, e in bounds:
        cpu.update(cpu_preds[s:e], cpu_targets[s:e])
    cpu_t0 = time.perf_counter()
    cpu_value = cpu.compute()
    cpu_compute_s = time.perf_counter() - cpu_t0
    for k, w in cpu_value.items():
        g = value[k].cpu()
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"detection (14c) {k}: the card's {g} differs from the CPU instance's {w}")
    cpu_s = time.perf_counter() - t_cpu

    t_oracle = time.perf_counter()
    m = MAP_ORACLE_IMAGES
    small = mt.MeanAveragePrecision(class_metrics=True)
    for s in range(0, m, MAP_BATCH):
        small.update(preds[s : min(s + MAP_BATCH, m)], targets[s : min(s + MAP_BATCH, m)])
    got = small.compute()
    as_np = [{k: v.double().numpy() if v.is_floating_point() else v.numpy() for k, v in d.items()} for d in cpu_preds[:m]]
    gts = [{k: v.double().numpy() if v.is_floating_point() else v.numpy() for k, v in d.items()} for d in cpu_targets[:m]]
    want = coco_eval(as_np, gts, class_metrics=True)
    for k, w in want.items():
        _close(f"detection (14c) {k}: the first {m} images against the numpy COCO oracle", got[k], np.asarray(w), atol=MAP_ORACLE_ATOL)
    oracle_s = time.perf_counter() - t_oracle
    scalars = {k: round(float(v), 6) for k, v in value.items() if v.ndim == 0}
    return (
        f"detection (14c): reduced: images from COCO val2017's {COCO_VAL2017[0]} to {n_img}, ground truths in proportion;"
        f" {COCO_VAL2017[1]} classes, {sum(gt_counts)} ground truths, {sum(det_counts)} detections, batches of {MAP_BATCH} ({len(bounds)} updates), class_metrics; data {data_s:.1f} s; {smi}:"
        f" {scalars}; {note}; an update checked for {syncs} host syncs and {copies} host-to-device copies; states"
        f" {state_bytes / 1e6:.1f} MB on the card, peak {peak / 2**20:.1f} MiB above the start; compute() {compute_ms / 1e3:.1f} s"
        f" (one copy to pinned host memory, then the host float64 evaluation); the CPU instance's compute() {cpu_compute_s:.1f} s, equal bit for bit on"
        f" all {len(value)} outputs ({cpu_s:.1f} s with its updates); the first {m} images within {MAP_ORACLE_ATOL:g} of the numpy"
        f" COCO oracle ({oracle_s:.1f} s)"
    )


def run_audio_detection_phase(torch, mt, smi: str) -> None:
    """Phase 14: speech separation, speech enhancement and COCO detection at their test-set sizes."""
    import metrics_tpu_torch.functional as ft

    t_phase = time.perf_counter()
    t_sub = time.perf_counter()
    _log(run_separation(torch, mt, ft, smi))
    _log(f"phase 14a: {time.perf_counter() - t_sub:.1f} s")
    torch.cuda.empty_cache()
    t_sub = time.perf_counter()
    _log(run_enhancement(torch, mt, ft, smi))
    _log(f"phase 14b: {time.perf_counter() - t_sub:.1f} s")
    torch.cuda.empty_cache()
    t_sub = time.perf_counter()
    _log(run_detection(torch, mt, smi))
    _log(f"phase 14c: {time.perf_counter() - t_sub:.1f} s")
    torch.cuda.empty_cache()
    _log(f"phases 14a-14c: {time.perf_counter() - t_phase:.1f} s in all, oracles and data included")


OBS_PASSES = 5  # passes of the ImageNet stream per observability mode; the median is logged
OBS_NEW_ROWS = 1000  # rows of the batch that makes phase 15's one new capture
ENCODE_CHUNKS = (512, 512, 300)  # phase 15's encoder stream: two full chunks and a ragged tail
ENCODE_WIDTH = (512, 128)  # input features, output features


def _encode_apply(params, x):
    return x @ params["w"]


def _encode_consumer(carry, feats, valid):
    return {"s": carry["s"] + (feats * valid[:, None]).sum(0), "n": carry["n"] + valid.sum()}


def _obs_pass(torch, mc, logits, target, bounds):
    """One pass of the ImageNet stream through ``mc.forward``, then ``compute()``."""
    mc.reset()
    for s, e in bounds:
        mc(logits[s:e], target[s:e])
    return mc.compute()


def _obs_mode(torch, mt, mc, logits, target, bounds):
    """``OBS_PASSES`` passes: the last result, the median ms per batch on
    the host clock (compute included), and the engine's counters before and
    after."""
    before = mt.engine.cache_summary()
    times, result = [], None
    for _ in range(OBS_PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = _obs_pass(torch, mc, logits, target, bounds)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / len(bounds))
    return result, sorted(times)[len(times) // 2], before, mt.engine.cache_summary()


def _engine_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in ("calls", "compiles", "cache_hits", "retraces", "graphs", "failed_captures")}


def _check_prometheus(text: str) -> int:
    """Every sample line parses as ``name{labels} value`` under a TYPE line
    of its family; returns the sample count."""
    import re

    typed, samples = set(), 0
    pattern = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*",?)*\})? (\S+)$')
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            typed.add(line.split()[2])
            continue
        m = pattern.match(line)
        if m is None or m.group(1) not in typed:
            raise AssertionError(f"phase 15: Prometheus line does not parse: {line!r}")
        float(m.group(5))
        samples += 1
    return samples


def _check_snapshot(mt, mc) -> None:
    """``obs.snapshot(mc)`` equals ``mc.obs_snapshot()``, and each section
    equals the legacy report it stands for."""
    snap = mt.obs.snapshot(mc)
    if snap != mc.obs_snapshot():
        raise AssertionError("phase 15: obs.snapshot(mc) differs from mc.obs_snapshot()")
    if snap["fused_compile"] != {k: v for k, v in mc.compile_stats().items() if k != "members"}:
        raise AssertionError(f"phase 15: fused_compile {snap['fused_compile']} vs compile_stats()")
    for surface, method in (("sync", "sync_report"), ("health", "health_report")):
        legacy = {k: v for k, v in getattr(mc, method)().items() if k != "members"}
        if snap[surface] != legacy:
            raise AssertionError(f"phase 15: snapshot {surface} {snap[surface]} vs {method}() {legacy}")
    for key, m in mc.items(keep_base=True):
        member = snap["members"][key]
        for surface, method in (("compile", "compile_stats"), ("sync", "sync_report"), ("health", "health_report")):
            if member[surface] != getattr(m, method)():
                raise AssertionError(f"phase 15: member {key} {surface} differs from {method}()")


def _obs_capture_check(torch, mt, mc, logits, target) -> str:
    """One new capture of the main path's fused forward (a batch of a new
    shape): one ``compile`` event, and ``kernel`` events exactly the
    warm-up's launches plus the launches the capture recorded."""
    graphs_before = {id(g) for g in mc._fused_fwd_fn.graphs}
    with mt.obs.capture() as events:
        _reset_stats(torch, mt)
        mc(logits[:OBS_NEW_ROWS], target[:OBS_NEW_ROWS])
        torch.cuda.synchronize()
    warm = {op: r["launches"] for op, r in mt.kernel_stats().items()}
    (graph,) = [g for g in mc._fused_fwd_fn.graphs if id(g) not in graphs_before]
    kinds = [e.kind for e in events]
    for op in set(warm) | set(graph.launches):
        got = len([e for e in events if e.kind == "kernel" and e.data["op"] == op and e.data["path"] == "cuda"])
        if got != warm.get(op, 0) + graph.launches.get(op, 0):
            raise AssertionError(f"phase 15: {got} kernel events of {op} at a capture, {warm} warm-up and {graph.launches} captured launches")
    # a program beyond the variant's first is a retrace; the variant's earlier
    # programs were captured with the bus off, so this one has no signature to
    # diff against, and a second new shape is named against this one
    programs = [e for e in events if e.kind in ("compile", "retrace")]
    if len(programs) != 1 or kinds.count("cache_hit") or kinds.count("forward") != 1:
        raise AssertionError(f"phase 15: events of one new capture {kinds}")
    with mt.obs.capture(kinds=("retrace",)) as second:
        mc(logits[:OBS_NEW_ROWS // 2], target[:OBS_NEW_ROWS // 2])
    if len(second) != 1 or second[0].data["explain"]["changed"] != ["avals"]:
        raise AssertionError(f"phase 15: a second new shape's retrace events {[e.data for e in second]}")
    return (
        f"one new capture ({OBS_NEW_ROWS} rows): a {programs[0].kind} event"
        f" {programs[0].data.get('explain', {}).get('changed', '')}, {kinds.count('kernel')} kernel events ="
        f" warm-up {warm} + captured {graph.launches}; a second ({OBS_NEW_ROWS // 2} rows): retrace"
        f" {second[0].data['explain']['detail']}"
    )


def _obs_encoder_check(torch, mt) -> str:
    """A seeded ``ShardedEncoder`` stream of three chunks with a ragged tail
    on the card: three ``encode`` events, their rows the real rows."""
    from metrics_tpu_torch.encoders import ShardedEncoder, encode_stream

    rng = np.random.default_rng(SEED + 15)
    d_in, d_out = ENCODE_WIDTH
    enc = ShardedEncoder(_encode_apply, {"w": torch.from_numpy(rng.standard_normal((d_in, d_out), dtype=np.float32)).cuda()}, name="obs_mlp")
    chunks = [rng.standard_normal((n, d_in), dtype=np.float32) for n in ENCODE_CHUNKS]
    carry0 = {"s": torch.zeros(d_out, device="cuda"), "n": torch.zeros((), device="cuda")}
    with mt.obs.capture(kinds=("encode",)) as events:
        carry, result = encode_stream(enc, chunks, _encode_consumer, carry0)
    rows = sum(ENCODE_CHUNKS)
    # float64 numpy of the same sum; the card's float32 matmul within 1e-4 of its largest entry
    want = np.concatenate(chunks).astype(np.float64).sum(0) @ enc.params["w"].double().cpu().numpy()
    got = carry["s"].double().cpu().numpy()
    if len(events) != len(ENCODE_CHUNKS) or sum(e.data["rows"] for e in events) != rows or result.rows != rows:
        raise AssertionError(f"phase 15: encode events {[e.data for e in events]} for chunks {ENCODE_CHUNKS}")
    if int(carry["n"]) != rows or np.abs(got - want).max() > 1e-4 * np.abs(want).max():
        raise AssertionError(f"phase 15: encoder stream sum differs from numpy (max abs err {np.abs(got - want).max()})")
    return f"encode events {[(e.data['rows'], e.data['bucket']) for e in events]} (rows, bucket), {enc.compile_stats()}"


def _obs_quarantine_check(torch, mt) -> str:
    """A NaN batch into an ``on_bad_input="raise"`` metric whose update is a
    graph replay: one ``quarantine`` event with ``path="compiled"``, before
    the raise."""
    m = mt.MeanSquaredError(on_bad_input="raise")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    preds = torch.rand(BATCH, device="cuda", generator=gen)
    target = torch.rand(BATCH, device="cuda", generator=gen)
    m.update(preds, target)  # the probe, a warm-up and the capture (or a hit on another instance's graph)
    m.update(preds, target)  # a replay
    bad = preds.clone()
    bad[BATCH // 2] = float("nan")
    with mt.obs.capture(kinds=("quarantine",)) as events:
        try:
            m.update(bad, target)
        except mt.NumericalHealthError:
            pass
        else:
            raise AssertionError("phase 15: the NaN batch did not raise")
    stats = m.compile_stats()
    if stats["jit_failed"] or stats["cache_hits"] < 2:
        raise AssertionError(f"phase 15: the raise-policy updates were not graph replays: {stats}")
    if [(e.data["path"], e.data["nan_count"], e.data["policy"]) for e in events] != [("compiled", 1, "raise")]:
        raise AssertionError(f"phase 15: quarantine events {[e.data for e in events]}")
    return f"quarantine event {events[0].data} after {stats['cache_hits']} replays"


def run_observability_phase(torch, mt, smi: str, mc, logits, target) -> dict:
    """Phase 15: the main path's collection (its programs captured by the
    main path) streams ImageNet-1k val three ways: the bus off; the bus on
    with unfenced tracing, which must capture nothing new, keep the
    engine's counters, make 0 host syncs a batch and give bitwise the same
    results, with an event per replay and a ``forward`` span per batch; and
    fenced tracing, whose mean ``forward`` span must cover the profiled
    device time of a batch. Then the exporters, the snapshot, one new
    capture's ``kernel`` events, an encoder stream and a compiled
    quarantine. Returns the launches of the bus-on passes."""
    obs = mt.obs
    t_phase = time.perf_counter()
    bounds = _batches(IMAGENET_VAL[0])
    obs.disable()
    obs.disable_tracing()
    obs.bus.clear()
    obs.trace.clear()

    # (1) the bus off
    off, off_ms, before_off, after_off = _obs_mode(torch, mt, mc, logits, target, bounds)
    off_syncs = _host_syncs(torch, lambda: _obs_pass(torch, mc, logits, target, bounds))

    # (2) the bus on, unfenced tracing
    obs.enable()
    obs.enable_tracing(fence=False)
    t0 = _reset_stats(torch, mt)
    on, on_ms, before_on, after_on = _obs_mode(torch, mt, mc, logits, target, bounds)
    _, on_stats = _read_stats(torch, mt, t0, {"select_topk": OBS_PASSES * len(bounds), "confusion_counts": OBS_PASSES * len(bounds)})
    events = obs.events()
    summary = obs.bus.summary()
    by_kind = summary["by_kind"]
    spans = obs.span_summary()
    obs.bus.clear()
    obs.trace.clear()
    on_syncs = _host_syncs(torch, lambda: _obs_pass(torch, mc, logits, target, bounds))
    obs.bus.clear()
    obs.trace.clear()
    delta = _engine_delta(before_on, after_on)
    for key in off:
        if not torch.equal(on[key], off[key]):
            raise AssertionError(f"phase 15: {key} with the bus on differs from the bus off (bitwise)")
    if delta["compiles"] or delta["retraces"] or delta["graphs"] or delta["failed_captures"]:
        raise AssertionError(f"phase 15: the bus on changed the programs: {delta}")
    if on_syncs or off_syncs:
        raise AssertionError(f"phase 15: host syncs a pass: {off_syncs} with the bus off, {on_syncs} on")
    if len([e for e in events if e.kind == "cache_hit"]) != delta["cache_hits"] or delta["cache_hits"] != delta["calls"]:
        raise AssertionError(f"phase 15: {by_kind.get('cache_hit', 0)} cache_hit events for {delta}")
    if by_kind.get("compile", 0) != delta["compiles"] or by_kind.get("kernel", 0) or by_kind.get("retrace", 0):
        raise AssertionError(f"phase 15: events {by_kind} for {delta}")
    forward = [e for e in events if e.kind == "forward"]
    if len(forward) != OBS_PASSES * len(bounds) or any(e.source != "MetricCollection" for e in forward):
        raise AssertionError(f"phase 15: {len(forward)} forward spans for {OBS_PASSES * len(bounds)} batches")
    if summary["dropped"] or summary["subscriber_errors"]:
        raise AssertionError(f"phase 15: the ring dropped events or a subscriber failed: {summary}")

    # (3) fenced tracing against the profiled device time of a batch
    obs.enable_tracing(fence=True)
    fenced, fenced_ms, before_f, after_f = _obs_mode(torch, mt, mc, logits, target, bounds)
    fenced_span_ms = obs.span_summary()["forward"]["MetricCollection"]["mean_s"] * 1e3
    obs.disable()
    obs.disable_tracing()
    for key in off:
        if not torch.equal(fenced[key], off[key]):
            raise AssertionError(f"phase 15: {key} under fenced tracing differs from the bus off (bitwise)")
    if _engine_delta(before_f, after_f)["compiles"]:
        raise AssertionError("phase 15: fenced tracing captured a program")
    # the bus off once more, last: the first way ran first after the phases before
    off_again, off_again_ms, _, _ = _obs_mode(torch, mt, mc, logits, target, bounds)
    if any(not torch.equal(off_again[key], off[key]) for key in off):
        raise AssertionError("phase 15: the bus off again differs from the bus off (bitwise)")
    mc.reset()
    profiled = _measure_batches(torch, [lambda s=s, e=e: mc(logits[s:e], target[s:e]) for s, e in bounds])
    if fenced_span_ms < profiled["device_ms"]:
        raise AssertionError(f"phase 15: the fenced forward span {fenced_span_ms:.3f} ms is below the device time {profiled['device_ms']:.3f} ms")

    # the exporters, the snapshot and the registry's section
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "events.jsonl")
        written = obs.to_jsonl(path, events)
        if written != len(events) or obs.validate_jsonl(path) != written:
            raise AssertionError(f"phase 15: {written} JSONL lines for {len(events)} events")
    samples = _check_prometheus(obs.prometheus_text(mc))
    kernels = obs.snapshot()["kernels"]
    stats = mt.kernel_stats()
    if kernels["by_op"] != stats or kernels["launches"] != sum(r["launches"] for r in stats.values()):
        raise AssertionError(f"phase 15: snapshot kernels {kernels} vs kernel_stats() {stats}")
    _check_snapshot(mt, mc)

    capture_note = _obs_capture_check(torch, mt, mc, logits, target)
    encoder_note = _obs_encoder_check(torch, mt)
    quarantine_note = _obs_quarantine_check(torch, mt)
    obs.disable()
    obs.bus.clear()
    obs.trace.clear()
    torch.cuda.empty_cache()
    _log(
        f"phase 15 observability: ImageNet-1k val, {len(bounds)} batches a pass, median of {OBS_PASSES} passes:"
        f" {off_ms:.3f} ms/batch with the bus off, {on_ms:.3f} with the bus on and unfenced tracing, {fenced_ms:.3f}"
        f" fenced, {off_again_ms:.3f} with the bus off again; host syncs a pass {off_syncs} off, {on_syncs} on; with the bus on: engine delta {delta}, events"
        f" {by_kind}, forward span mean {spans['forward']['MetricCollection']['mean_s'] * 1e3:.3f} ms (unfenced);"
        f" results bitwise equal; fenced forward span mean {fenced_span_ms:.3f} ms against the profiled device"
        f" {profiled['device_ms']:.3f} ms a batch (busy {profiled['busy_ms']:.3f} ms, wall {profiled['wall_ms']:.3f} ms);"
        f" launches with the bus on {({op: r['launches'] for op, r in on_stats.items()})}; {smi}"
    )
    _log(
        f"phase 15 exporters: {len(events)} events to JSONL, validated; {samples} Prometheus samples parsed;"
        f" snapshot kernels agree with kernel_stats(); obs.snapshot(mc) equals mc.obs_snapshot() and every legacy"
        f" report; {capture_note}; {encoder_note}; {quarantine_note}"
    )
    _log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return {op: on_stats[op]["launches"] for op in ("select_topk", "confusion_counts")}


# kernel wrappers' device-side names, as the profiler reports them; a
# wrapper that runs several kernels per call lists them all
# ---------------------------------------------------------------------------
# phase 16: the sharded state plane (one card: NCCL at world size 1, and four
# gloo ranks on cuda:0)
# ---------------------------------------------------------------------------
SHARD_WORLD = 4
SHARD_RANK_TIMEOUT_S = 540
SHARD_SEED = 16
IMAGENET21K_VAL = (522_500, 10_450, 125)  # ImageNet-21K-P val (Ridnik et al. 2021): images, classes, steps of 4,180
IMAGENET21K_TOP1 = 0.6  # share of predictions that are the target (the rest uniform)
OPENIMAGES_VAL = (41_620, 19_957, 10)  # Open Images V6 val, image-level labels: images, classes, steps of 4,162
OPENIMAGES_POSITIVES = 8.4  # positive labels per image
OPENIMAGES_CHUNK = 2  # steps per program replay: the static copy of a chunk is 2 x 166 MB per input per rank
FID_SHARDED = (10_000, 2048)  # CIFAR-10 test size: real and generated features each, width
SHARD_MAIN = (8, 6_250)  # the main path's ImageNet-1k val collection as 8 steps of 6,250
SHARD_FID_RTOL = 1e-6


def _imagenet21k_labels(torch, gen):
    """ImageNet-21K-P val's 50 images per class, shuffled; predictions the
    target or a uniform class. ``[steps, 4180]`` int32 on the card."""
    n, c, steps = IMAGENET21K_VAL
    target = torch.arange(c, device="cuda", dtype=torch.int32).repeat(n // c)
    target = target[torch.randperm(n, generator=gen, device="cuda")]
    other = torch.randint(0, c, (n,), generator=gen, device="cuda", dtype=torch.int32)
    keep = torch.rand(n, generator=gen, device="cuda") < IMAGENET21K_TOP1
    preds = torch.where(keep, target, other)
    return preds.view(steps, n // steps), target.view(steps, n // steps)


def _openimages_labels(torch, gen):
    """Seeded multilabel epoch of Open Images V6 val size: ``[steps, 4162,
    19957]`` float32 scores (positives shifted up) and int32 0/1 labels,
    made step by step on the card."""
    n, c, steps = OPENIMAGES_VAL
    rows = n // steps
    probs = torch.empty((steps, rows, c), device="cuda")
    labels = torch.empty((steps, rows, c), device="cuda", dtype=torch.int32)
    for k in range(steps):
        torch.rand((rows, c), generator=gen, device="cuda", out=probs[k])
        labels[k] = (probs[k] < OPENIMAGES_POSITIVES / c).to(torch.int32)
        torch.rand((rows, c), generator=gen, device="cuda", out=probs[k])
        probs[k].mul_(0.65).add_(0.35 * labels[k])  # stays in [0, 1)
    return probs, labels


def _shard_main_epoch(torch, gen):
    steps, rows = SHARD_MAIN
    c = IMAGENET_VAL[1]
    target = torch.randint(0, c, (steps, rows), generator=gen, device="cuda")
    logits = torch.randn((steps, rows, c), generator=gen, device="cuda")
    logits.scatter_add_(2, target[..., None], torch.full((steps, rows, 1), 3.0, device="cuda"))
    return logits, target


def _local_collection(mt):
    """The main path's collection with the host sync of its compute() off
    (the reference of a mesh drive, run in one process of a world)."""
    mc = _imagenet_collection(mt)
    for m in mc.values():
        m._distributed_available_fn = lambda: False
    return mc


def _values_equal(name: str, got: dict, want: dict) -> None:
    for key, w in want.items():
        if not torch_equal(got[key], w):
            raise AssertionError(f"{name} {key}: differs from the local drive (bit for bit)")


def _member_states(mc) -> dict:
    return {f"{k}.{n}": v for k, m in mc.items() for n, v in m._snapshot_state().items()}


def _states_equal(name: str, got, want: dict) -> None:
    """Every state of every member bit for bit against the local drive's
    (``want``: :func:`_member_states` of it)."""
    _values_equal(f"{name} state", _member_states(got), want)


def torch_equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool((a == b).all())


_REFUSALS: list = []  # the errors of refused programs in this process, newest last


def _record_refusals() -> None:
    """Keep each error a program raised before the engine falls back on it,
    so that a phase that requires captures can say why one was refused."""
    from metrics_tpu_torch.engine import cache

    invoke = cache.SharedEntry.invoke

    def recorded(self, *args, **kwargs):
        try:
            return invoke(self, *args, **kwargs)
        except cache.FALLBACK_ERRORS as err:
            _REFUSALS.append(f"{self.kind}: {type(err).__name__}: {str(err)[:500]}")
            raise

    cache.SharedEntry.invoke = recorded


def _require_captured(name: str, obj) -> str:
    """Every member's chunks ran as captured programs (no fallback)."""
    captures, hits, eager = _program_counts(obj)
    if eager or captures < 1:
        raise AssertionError(f"{name}: not captured as programs: {obj.compile_stats()}; refusals {_REFUSALS[-3:]}")
    return f"programs: {captures} captured, {hits} cache hits, sync {obj.compile_stats().get('mesh_sync')}"


def _confusion_oracle(preds: np.ndarray, target: np.ndarray, c: int) -> np.ndarray:
    return np.bincount(target.astype(np.int64) * c + preds, minlength=c * c).reshape(c, c)


def _shard_rank(rank: int, port: int, out_path: str) -> None:
    """One rank of phase 16b (this script run with ``--shard-rank``): join
    the gloo world of four on ``cuda:0``, lay a ``(2, 2)`` ``("dp", "mp")``
    mesh over it, run every case at full size and save the checks' results."""
    import torch
    import torch.distributed as dist
    from datetime import timedelta

    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.engine import clear_cache, drive
    from metrics_tpu_torch.parallel import comm
    from metrics_tpu_torch.sharding import PartitionSpec as P

    torch.cuda.set_device(0)
    _record_refusals()
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=SHARD_WORLD, rank=rank, timeout=timedelta(seconds=300)
    )
    rec = {"rank": rank}
    try:
        mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("dp", "mp"))
        dp, mp = mesh.get_local_rank("dp"), mesh.get_local_rank("mp")
        gen = torch.Generator(device="cuda").manual_seed(SHARD_SEED)

        # ImageNet-21K-P val: class-split confusion matrix and macro stat scores
        n, c, steps = IMAGENET21K_VAL
        preds, target = _imagenet21k_labels(torch, gen)
        coll = mt.MetricCollection(
            {
                "cm": mt.ConfusionMatrix(num_classes=c, class_sharding="mp"),
                "ss": mt.StatScores(reduce="macro", num_classes=c, class_sharding="mp"),
            }
        )
        mt.sharding.reset_shard_stats()
        t0 = _reset_stats(torch, mt)
        res = drive(coll, (preds, target), mesh=mesh, in_specs=P(None, "dp"))
        torch.cuda.synchronize()
        rec["drive21k_s"] = time.perf_counter() - t0
        rec["launches21k"] = {op: s["launches"] for op, s in mt.kernel_stats().items()}
        rec["programs21k"] = _require_captured("ImageNet-21K-P drive", coll)
        cm, ss = coll["cm"], coll["ss"]
        layout = cm._shard_layout["confmat"]
        r0, rows = layout.offsets[0], layout.local_shape[0]
        oracle = _confusion_oracle(preds.cpu().numpy().ravel(), target.cpu().numpy().ravel(), c)
        if res.fused_keys != ("cm", "ss") or cm.confmat.shape != (rows, c) or rows != c // 2:
            raise AssertionError(f"ImageNet-21K-P: fused {res.fused_keys}, shard {tuple(cm.confmat.shape)}")
        if not np.array_equal(cm.confmat.cpu().numpy(), oracle[r0:r0 + rows]):
            raise AssertionError(f"ImageNet-21K-P rank {rank}: the shard differs from rows {r0}..{r0 + rows - 1} of the oracle")
        resident = mt.sharding.shard_stats()["resident"]["ConfusionMatrix.confmat"]
        if resident["per_device_bytes"] * 2 != resident["total_bytes"]:
            raise AssertionError(f"ImageNet-21K-P: resident {resident}")
        rec["resident"] = resident
        t0 = time.perf_counter()
        values = coll.compute()
        torch.cuda.synchronize()
        rec["compute21k_s"] = time.perf_counter() - t0
        if not np.array_equal(values["cm"].cpu().numpy(), oracle):
            raise AssertionError("ImageNet-21K-P: compute() differs from the oracle")
        tp = np.diag(oracle)
        fp, fn = oracle.sum(0) - tp, oracle.sum(1) - tp
        want_ss = np.stack([tp, fp, n - tp - fp - fn, fn, tp + fn], axis=1)
        if not np.array_equal(values["ss"].cpu().numpy(), want_ss):
            raise AssertionError("ImageNet-21K-P: macro StatScores compute() differs from the oracle")
        rec["top1"] = float(tp.sum() / n)
        # the sync's collective alone: one all-reduce of the shard over dp
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comm.reduce_in_trace(cm.confmat, "sum", "dp", mesh=mesh)
        torch.cuda.synchronize()
        rec["allreduce_ms"] = (time.perf_counter() - t0) * 1e3
        rec["shard_mb"] = cm.confmat.numel() * 8 / 1e6
        del coll, cm, ss, values, oracle, preds, target
        clear_cache()  # the captured graphs hold their buffers
        torch.cuda.empty_cache()

        # Open Images V6 val: class-split multilabel confusion matrix
        n, c, steps = OPENIMAGES_VAL
        probs, labels = _openimages_labels(torch, gen)
        rec["free_gb_ml"] = torch.cuda.mem_get_info()[0] / 1e9
        ml = mt.ConfusionMatrix(num_classes=c, multilabel=True, class_sharding="mp")
        t0 = _reset_stats(torch, mt)
        drive(ml, (probs, labels), mesh=mesh, in_specs=P(None, "dp"), steps_per_chunk=OPENIMAGES_CHUNK)
        torch.cuda.synchronize()
        rec["driveml_s"] = time.perf_counter() - t0
        rec["launchesml"] = {op: s["launches"] for op, s in mt.kernel_stats().items()}
        rec["programsml"] = _require_captured("Open Images drive", ml)
        layout = ml._shard_layout["confmat"]
        c0, w = layout.offsets[0], layout.local_shape[0]
        sums = torch.zeros((3, w), dtype=torch.int64, device="cuda")
        for k in range(steps):
            p = (probs[k, :, c0:c0 + w] >= 0.5).long()
            t = labels[k, :, c0:c0 + w].long()
            sums += torch.stack([(p * t).sum(0), p.sum(0), t.sum(0)])
        tp_, sp, st_ = sums
        want = torch.stack([n - sp - st_ + tp_, sp - tp_, st_ - tp_, tp_], dim=-1).view(w, 2, 2)
        if not torch_equal(ml.confmat, want):
            raise AssertionError(f"Open Images rank {rank}: the shard differs from columns {c0}..{c0 + w - 1} of the oracle")
        rec["ml_window"] = (c0, w)
        full = ml.compute()
        if full.shape != (c, 2, 2) or not torch_equal(full[c0:c0 + w], want):
            raise AssertionError("Open Images: compute() differs from the shard")
        del probs, labels, ml, full
        clear_cache()
        torch.cuda.empty_cache()

        # FID with feature-split moments, d = 2048, CIFAR-10 test size
        rows, d = FID_SHARDED
        real = torch.randn((rows, d), generator=gen, device="cuda")
        fake = 1.1 * torch.randn((rows, d), generator=gen, device="cuda") + 0.05
        sharded = mt.FrechetInceptionDistance(feature=lambda x: x, feature_dim=d, feature_sharding="mp")
        sharded.shard_states(mesh)
        sharded.update(real.chunk(2)[dp], real=True)  # one mp group feeds one half
        sharded.update(fake.chunk(2)[dp], real=False)
        t0 = time.perf_counter()
        value = float(sharded.compute())
        rec["fid_compute_s"] = time.perf_counter() - t0
        whole = mt.FrechetInceptionDistance(feature=lambda x: x, feature_dim=d, matrix_sqrt="newton_schulz")
        whole._distributed_available_fn = lambda: False
        whole.update(real, real=True)
        whole.update(fake, real=False)
        ref = float(whole.compute())
        ref64 = _newton_schulz_reference(torch, whole, whole.sqrt_iters)
        for label, want_v in (("unsharded Newton–Schulz", ref), ("float64 restatement", ref64)):
            if abs(value - want_v) > SHARD_FID_RTOL * abs(want_v):
                raise AssertionError(f"sharded FID {value!r} vs the {label} {want_v!r} (rtol {SHARD_FID_RTOL})")
        rec["fid"] = (value, ref, ref64, tuple(sharded.real_outer.shape))
        del real, fake, sharded, whole
        torch.cuda.empty_cache()

        # the main path's collection, its steps split over the mesh
        logits, target = _shard_main_epoch(torch, gen)
        local = _local_collection(mt)
        drive(local, (logits, target))
        want, states = local.compute(), _member_states(local)
        rec["main"] = {}
        for label, shape, names, axis, hier in (
            ("axis_name='dp' on (4,)", (4,), ("dp",), "dp", False),
            ("axis_name=('host', 'local'), hierarchical on (2, 2)", (2, 2), ("host", "local"), ("host", "local"), True),
        ):
            m_mesh = init_device_mesh("cuda", shape, mesh_dim_names=names)
            mc = _imagenet_collection(mt)
            t0 = _reset_stats(torch, mt)
            drive(mc, (logits, target), mesh=m_mesh, axis_name=axis, hierarchical_sync=hier)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {op: s["launches"] for op, s in mt.kernel_stats().items()}
            _values_equal(f"main path {label}", mc.compute(), want)
            _states_equal(f"main path {label}", mc, states)
            rec["main"][label] = (seconds, launches, _require_captured(label, mc))

        # the fleet's mesh change: the main path's class-split confusion
        # matrix re-laid from (2, 2) onto (1, 4) and back, verified on the
        # gathered global state at each move
        from metrics_tpu_torch.fleet import reshard_onto

        cm = mt.ConfusionMatrix(num_classes=IMAGENET_VAL[1], class_sharding="mp")
        t0 = _reset_stats(torch, mt)
        drive(cm, (logits, target), mesh=mesh, in_specs=P(None, "dp"))
        torch.cuda.synchronize()
        launches = {op: s["launches"] for op, s in mt.kernel_stats().items() if s["launches"]}
        before = cm.compute()
        if not torch_equal(before, want["confmat"]):
            raise AssertionError(f"reshard rank {rank}: the class-split drive differs from the local drive")
        mesh14 = init_device_mesh("cuda", (1, 4), mesh_dim_names=("dp", "mp"))
        moves = []
        for target_mesh, shard in ((mesh14, (IMAGENET_VAL[1] // 4, IMAGENET_VAL[1])), (mesh, (IMAGENET_VAL[1] // 2, IMAGENET_VAL[1]))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reshard_onto(cm, target_mesh, verify=True)
            torch.cuda.synchronize()
            moves.append((time.perf_counter() - t0) * 1e3)
            if tuple(cm.confmat.shape) != shard or not torch_equal(cm.compute(), before):
                raise AssertionError(f"reshard rank {rank}: after the move to {shard} the value changed")
        rec["reshard"] = (moves, launches, mt.sharding.shard_stats()["mesh_changes"])
        del cm
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(rec, out_path)


def _memory_note(torch) -> str:
    """The card's free memory, the host's available memory and this
    process's resident size, for the lines around a launch of ranks."""
    free, total = torch.cuda.mem_get_info()
    reserved = torch.cuda.memory_reserved()
    host = {}
    for path, keys in (("/proc/meminfo", ("MemAvailable", "MemTotal")), ("/proc/self/status", ("VmRSS",))):
        try:
            with open(path) as f:
                for line in f:
                    key, _, rest = line.partition(":")
                    if key in keys:
                        host[key] = int(rest.split()[0]) * 1024
        except OSError:
            pass
    gb = lambda k: f"{host[k] / 1e9:.1f} GB" if k in host else "not measured"
    return (
        f"card free {free / 1e9:.1f} GB of {total / 1e9:.1f} GB, {reserved / 1e9:.1f} GB reserved by this process; host available {gb('MemAvailable')} of {gb('MemTotal')};"
        f" this process resident {gb('VmRSS')}"
    )


def _exit_note(rc) -> str:
    if isinstance(rc, int) and rc < 0:
        import signal

        return f"killed by {signal.Signals(-rc).name}"
    return f"exit code {rc}"


def _run_shard_ranks(
    out_dir: str,
    flag: str = "--shard-rank",
    phase: str = "16b",
    timeout_s: float = SHARD_RANK_TIMEOUT_S,
    extra: tuple = (),
    env: dict = None,
):
    """Start the four ranks of a phase (phase 16b's by default: this script
    run with ``flag``, then ``extra`` arguments, in ``env``), wait for each
    within its limit and return their records; a rank that fails or outlives
    its limit raises."""
    import torch

    port = _free_port()
    procs = []
    stem = flag.strip("-").split("-")[0]
    _log(f"phase {phase}: starting {SHARD_WORLD} ranks; {_memory_note(torch)}")
    for rank in range(SHARD_WORLD):
        log = open(os.path.join(out_dir, f"{stem}{rank}.log"), "w+")
        cmd = [sys.executable, os.path.abspath(__file__), flag, str(rank), str(port), os.path.join(out_dir, f"{stem}{rank}.pt"), *extra]
        procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env), log))
    ended = {}  # rank -> (seconds after the start, return code), in the order the ranks ended
    t0 = time.monotonic()
    try:
        while len(ended) < len(procs) and time.monotonic() - t0 < timeout_s:
            for rank, (proc, _) in enumerate(procs):
                if rank not in ended and proc.poll() is not None:
                    ended[rank] = (time.monotonic() - t0, proc.returncode)
            time.sleep(0.05)
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = [(r, rc) for r, (_, rc) in ended.items() if rc != 0]
    failed += [(r, f"killed after {timeout_s} s") for r in range(len(procs)) if r not in ended]
    logs = []
    for _, log in procs:
        log.seek(0)
        logs.append(log.read())
        log.close()
    if failed:
        # the rank that failed first is the likely cause (the others then lose their gloo peer): its log goes last
        first = failed[0][0]
        order = [r for r in range(len(procs)) if r != first] + [first]
        tails = "\n".join(f"--- rank {r} ---\n{logs[r][-6000:]}" for r in order)
        how = {r: f"{t:.1f} s, {_exit_note(rc)}" for r, (t, rc) in ended.items()}
        raise AssertionError(
            f"phase {phase}: ranks failed {failed}\n{tails}\nphase {phase}: ranks failed {failed}; first to fail rank {first};"
            f" ended after {how}; {_memory_note(torch)}"
        )
    return [torch.load(os.path.join(out_dir, f"{stem}{r}.pt"), weights_only=False) for r in range(SHARD_WORLD)]


def _world_one_phase(torch, mt, smi: str) -> dict:
    """Phase 16a: an NCCL group of one in this process, a ``(1, 1)``
    ``("dp", "mp")`` mesh; the main path's collection with
    ``axis_name="dp"`` and the class-split ImageNet-21K-P collection, each
    bit for bit against its local drive, captured, with no host sync."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from metrics_tpu_torch.engine import drive
    from metrics_tpu_torch.sharding import PartitionSpec as P

    gen = torch.Generator(device="cuda").manual_seed(SHARD_SEED)
    logits, target = _shard_main_epoch(torch, gen)
    preds21k, target21k = _imagenet21k_labels(torch, gen)
    c21k = IMAGENET21K_VAL[1]

    def sharded21k(**kw):
        return mt.MetricCollection(
            {
                "cm": mt.ConfusionMatrix(num_classes=c21k, **kw),
                "ss": mt.StatScores(reduce="macro", num_classes=c21k, **kw),
            }
        )

    local, local21k = _imagenet_collection(mt), sharded21k()
    drive(local, (logits, target))
    drive(local21k, (preds21k, target21k))
    want, want21k = local.compute(), local21k.compute()
    states, states21k = _member_states(local), _member_states(local21k)
    launches = {}
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0, device_id=torch.device("cuda:0")
    )
    notes = []
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("dp", "mp"))
        for label, obj, epoch, kw, reference, ref_states in (
            ("main path, axis_name='dp'", _imagenet_collection(mt), (logits, target), {"axis_name": "dp"}, want, states),
            (
                "ImageNet-21K-P, in_specs=P(None, 'dp')", sharded21k(class_sharding="mp"), (preds21k, target21k),
                {"in_specs": P(None, "dp")}, want21k, states21k,
            ),
        ):
            drive(obj, epoch, mesh=mesh, **kw)  # captures
            obj.reset()
            t0 = _reset_stats(torch, mt)
            syncs = _host_syncs(torch, lambda: drive(obj, epoch, mesh=mesh, **kw))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            for op, s in mt.kernel_stats().items():
                launches[op] = launches.get(op, 0) + s["launches"]
            _values_equal(f"phase 16a {label}", obj.compute(), reference)
            _states_equal(f"phase 16a {label}", obj, ref_states)
            note = _require_captured(f"phase 16a {label}", obj)
            if syncs:
                raise AssertionError(f"phase 16a {label}: {syncs} host syncs in the drive")
            notes.append(f"{label}: {seconds * 1e3:.1f} ms, 0 host syncs, {note}")
            del obj
    finally:
        dist.destroy_process_group()
    # the four ranks of 16b share the card: free this process's programs and buffers
    del local, local21k, want, want21k, states, states21k, logits, target, preds21k, target21k
    mt.engine.clear_cache()
    torch.cuda.empty_cache()
    _log(f"phase 16a NCCL world size 1 ((1, 1) mesh): bit for bit against the local drives; " + "; ".join(notes) + f"; {smi}")
    return launches


def run_sharded_phase(torch, mt, smi: str) -> dict:
    """Phase 16: the sharded state plane. (a) NCCL at world size 1 in this
    process; (b) four gloo ranks on ``cuda:0`` (this script run with
    ``--shard-rank``) on a ``(2, 2)`` mesh at full size. Returns the
    launches per op, the windowed ones under ``op@window``."""
    t_phase = time.perf_counter()
    _record_refusals()
    mt.engine.clear_cache()  # the last phase: the earlier phases' programs and buffers go
    torch.cuda.empty_cache()
    launches = _world_one_phase(torch, mt, smi)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        ranks = _run_shard_ranks(out_dir)
    for rec in ranks:
        if rec["launches21k"].get("confusion_counts", 0) <= 0 or rec["launchesml"].get("multilabel_counts", 0) <= 0:
            raise AssertionError(f"phase 16b rank {rec['rank']}: windowed launches {rec['launches21k']} {rec['launchesml']}")
    n, c, steps = IMAGENET21K_VAL
    for rec in ranks:
        _log(
            f"phase 16b rank {rec['rank']} ImageNet-21K-P ({n} images, {c} classes, {steps} steps): shard of"
            f" {rec['shard_mb']:.0f} MB equals its rows of the np.bincount oracle, compute() equals the oracle (top1"
            f" {rec['top1']:.6f}); drive {rec['drive21k_s'] * 1e3:.0f} ms, compute() {rec['compute21k_s'] * 1e3:.0f} ms,"
            f" gloo all-reduce of the shard over dp {rec['allreduce_ms']:.1f} ms; resident {rec['resident']};"
            f" launches {rec['launches21k']}; {rec['programs21k']}"
        )
        _log(
            f"phase 16b rank {rec['rank']} Open Images V6 ({OPENIMAGES_VAL[0]} images, {OPENIMAGES_VAL[1]} classes):"
            f" columns {rec['ml_window']} equal the oracle; drive {rec['driveml_s'] * 1e3:.0f} ms; launches"
            f" {rec['launchesml']}; {rec['programsml']}"
        )
        value, ref, ref64, shape = rec["fid"]
        _log(
            f"phase 16b rank {rec['rank']} FID d={FID_SHARDED[1]} ({FID_SHARDED[0]} + {FID_SHARDED[0]} features,"
            f" local outer {shape}): {value!r} vs unsharded Newton–Schulz {ref!r} and float64 {ref64!r};"
            f" compute() {rec['fid_compute_s'] * 1e3:.0f} ms"
        )
        for label, (seconds, ops, note) in rec["main"].items():
            _log(f"phase 16b rank {rec['rank']} main path {label}: {seconds * 1e3:.0f} ms, bit for bit against the local drive; launches {ops}; {note}")
        moves, ops, changes = rec["reshard"]
        _log(
            f"phase 16b rank {rec['rank']} reshard: ConfusionMatrix({IMAGENET_VAL[1]}, class_sharding='mp') driven on the"
            f" (2, 2) mesh, reshard_onto (1, 4) {moves[0]:.1f} ms and back to (2, 2) {moves[1]:.1f} ms (verify=True: the"
            f" gathered global state bit for bit), compute() bit for bit against the local drive after each move;"
            f" mesh_changes {changes}; launches {ops}"
        )
        _log(f"phase 16b rank {rec['rank']}: peak memory {rec['peak_gb']:.2f} GB; {rec['free_gb_ml']:.1f} GB free on the card before the Open Images drive")
    for op in ("confusion_counts", "select_topk"):
        launches[op] = launches.get(op, 0) + sum(rec["main"][label][1].get(op, 0) for rec in ranks for label in rec["main"])
    launches["confusion_counts@window"] = sum(
        rec["launches21k"]["confusion_counts"] + rec["reshard"][1].get("confusion_counts", 0) for rec in ranks
    )
    launches["multilabel_counts@window"] = sum(rec["launchesml"]["multilabel_counts"] for rec in ranks)
    _log(f"phase 16 sharded states: {time.perf_counter() - t_phase:.1f} s in all; {smi}")
    return launches


# ---------------------------------------------------------------------------
# phase 17: the encoder's mesh
# ---------------------------------------------------------------------------
ENC_RANK_TIMEOUT_S = 300
ENC_MESH_IMAGES = 1_024  # 17b: the first real and generated images of 12a's sets
ENC_MESH_CHUNK = 128  # 17b's stream chunks: four ranks share the card's memory (at 256 a rank's graph pool was 11.5 GiB, and a rank ran out)
ENC_MESH_PAIRS = 256  # 17b: BERTScore pairs of 13a
ENC_MESH_LAYERS = 2  # 17b: the seeded encoder cut to 2 layers, at full width
ENC_BLOCK_IMAGES = 32  # images whose feature block each rank returns
ENC_RTOL = 1e-6
BERT_KEYS = ("precision", "recall", "f1")


def _graph_pool_bytes(torch, pool=None):
    """Bytes the caching allocator holds reserved for a graph memory pool
    (its programs' outputs and intermediates): ``pool``, by default the
    engine's shared one; None where the allocator's snapshot does not name
    segment pools."""
    from metrics_tpu_torch.engine import cache

    if pool is None:
        pool = cache._POOLS.get(torch.cuda.current_device())
    segments = torch.cuda.memory_snapshot()
    if pool is None or not any("segment_pool_id" in seg for seg in segments):
        return None
    return sum(seg["total_size"] for seg in segments if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def _mib(n) -> str:
    return "not measured" if n is None else f"{n / 2**20:.1f} MiB"


def _bert_kw():
    return {"user_tokenizer": _bert_tokenizer, "idf": True, "max_length": BERT_MAX_LEN, "batch_size": BERT_BATCH}


def _bert_plain(torch, layers: int):
    """The unsharded seeded encoder as a plain callable (13e's route)."""
    from metrics_tpu_torch.image.networks._common import full_fp32

    params = _bert_params(torch, SEED, layers)

    def encoder(input_ids, attention_mask):
        with torch.no_grad(), full_fp32():
            return _bert_apply(params, input_ids, attention_mask)

    return encoder


def _bert_mesh_encoder(torch, mesh, layers: int):
    """The seeded encoder as ``apply_fn(params, ids, mask)`` in a
    ``ShardedEncoder``: every 2-D weight's first axis split over ``mp``,
    the sentence axis staged over ``dp``."""
    from metrics_tpu_torch.encoders import ShardedEncoder
    from metrics_tpu_torch.image.networks._common import full_fp32
    from metrics_tpu_torch.sharding import PartitionSpec as P

    def apply(params, input_ids, attention_mask):
        with torch.no_grad(), full_fp32():
            return _bert_apply(params, input_ids, attention_mask)

    return ShardedEncoder(
        apply, _bert_params(torch, SEED, layers), param_specs=lambda path, leaf: P("mp") if leaf.ndim == 2 else None,
        mesh=mesh, in_specs=P("dp"), out_spec=P("dp"), name=f"roberta_large_{layers}",
    )


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _encoder_world_one(torch, mt, ft, smi: str, path: str, pairs) -> None:
    """Phase 17a: an NCCL group of one in this process, a ``(1, 1)`` mesh.
    FID with ``encoder_sharding="mp"`` and ``feature_sharding="mp"`` over
    12a's sets at full InceptionV3 width against the unsharded
    stream, bit for bit, captured with the gather in the graph; BERTScore
    through the seeded encoder placed on the mesh against the plain route."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from metrics_tpu_torch import engine
    from metrics_tpu_torch.encoders import encoder_stats

    n = GEN_IMAGES
    real, fake = _cifar_sets(torch)
    chunks = {True: [real[s:e] for s, e in _batches_of(n, STREAM_CHUNK)], False: [fake[s:e] for s, e in _batches_of(n, STREAM_CHUNK)]}
    engine.clear_cache()
    torch.cuda.empty_cache()
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0, device_id=torch.device("cuda:0")
    )
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("dp", "mp"))

        def make(sharded: bool):
            if not sharded:
                return mt.FrechetInceptionDistance(feature=2048, weights_path=path)
            fid = mt.FrechetInceptionDistance(
                feature=2048, weights_path=path, feature_sharding="mp", encoder_sharding="mp", matrix_sqrt="eigh"
            )
            return fid.shard_states(mesh)

        # each route's first chunk captures its program (through a throwaway metric: the programs are shared)
        base = torch.cuda.memory_allocated()
        make(True).update_stream(chunks[True][:1], real=True)
        pool_sharded = _graph_pool_bytes(torch)
        make(False).update_stream(chunks[True][:1], real=True)
        fids = {True: make(True), False: make(False)}
        fids[False]._distributed_available_fn = lambda: False  # the unsharded reference: no sync
        runtime = fids[True]._encoder_runtime
        seconds, syncs = {}, {}
        torch.cuda.reset_peak_memory_stats()
        for sharded, real_set in ((True, True), (False, True), (False, False), (True, False)):  # in turns
            box = []
            syncs[sharded, real_set] = _host_syncs(
                torch, lambda: box.append(_timed(torch, lambda: fids[sharded].update_stream(chunks[real_set], real=real_set))[1])
            )
            seconds[sharded, real_set] = box[0]
        peak = torch.cuda.max_memory_allocated() - base
        names = [f"{p}_{k}" for p in ("real", "fake") for k in ("sum", "sum_c", "outer", "outer_c", "n")]
        differ = [k for k in names if not torch_equal(getattr(fids[True], k), getattr(fids[False], k))]
        if differ:
            raise AssertionError(f"phase 17a: the sharded stream's moments differ from the unsharded stream's: {differ}")
        value, want = float(fids[True].compute()), float(fids[False].compute())
        if value != want:
            raise AssertionError(f"phase 17a: sharded FID {value!r} against the unsharded stream's {want!r}")
        stats = runtime.compile_stats()
        summary = engine.cache.encoder_entry(runtime, consumer=fids[True]._moment_consumer()).summary()
        if stats.get("param_gather") != "in_program" or (summary["compiles"], summary["graphs"], summary["failed_captures"]) != (1, 1, 0):
            raise AssertionError(f"phase 17a: the sharded stream was not one captured program with the gather in it: {stats}, {summary}")
        if any(syncs[True, r] for r in (True, False)):
            raise AssertionError(f"phase 17a: host syncs in the sharded stream: {syncs}")
        # the gather alone as the program runs it: captured in a graph of its own and replayed (eager, each
        # of its 472 leaves' collectives waits on the host)
        runtime._gather(runtime.params, in_program=True)
        gather_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(gather_graph):
            runtime._gather(runtime.params, in_program=True)
        gather_ms = _cuda_ms(torch, gather_graph.replay, iters=20, warmup=3)
        del gather_graph
        record = encoder_stats()["encoders"]["inception_2048"]
        rate = {k: n / v for k, v in seconds.items()}
        chunk_ms = {k: 1e3 * v / len(chunks[k[1]]) for k, v in seconds.items()}
        _log(
            f"phase 17a FID encoder_sharding='mp' (NCCL world size 1, (1, 1) mesh), {n} real + {n} generated (reduced from CIFAR-10 test's {CIFAR10_TEST[0]})"
            f" images, chunks of {STREAM_CHUNK}, InceptionV3 at full width: moments and FID (eigh {value!r}) equal the unsharded"
            f" stream's bit for bit; {summary['graphs']} captured program ({summary['cache_hits']} replays), param_gather"
            f" {stats['param_gather']}, 0 host syncs;"
            f" images/s in turns sharded {rate[True, True]:.0f}, unsharded {rate[False, True]:.0f}, unsharded"
            f" {rate[False, False]:.0f}, sharded {rate[True, False]:.0f} (ms per chunk {chunk_ms[True, True]:.1f},"
            f" {chunk_ms[False, True]:.1f}, {chunk_ms[False, False]:.1f}, {chunk_ms[True, False]:.1f}); the gather alone,"
            f" captured and replayed, {gather_ms:.3f} ms (CUDA events); resident {record}; graph pool reserved {_mib(pool_sharded)} after the"
            f" sharded capture alone, {_mib(_graph_pool_bytes(torch))} with both programs; peak over the timed streams"
            f" {peak / 2**30:.2f} GiB; {smi}"
        )
        del fids, runtime
        engine.clear_cache()
        torch.cuda.empty_cache()

        # BERTScore: 13e's encoder on the mesh against its plain route
        preds, refs = pairs
        plain_encoder = _bert_plain(torch, BERT_LAYERS)
        plain, plain_s = _timed(torch, lambda: ft.bert_score(preds, refs, model=plain_encoder, **_bert_kw()))
        del plain_encoder
        enc = _bert_mesh_encoder(torch, mesh, BERT_LAYERS)
        sharded, sharded_s = _timed(torch, lambda: ft.bert_score(preds, refs, model=enc, **_bert_kw()))
        for key in BERT_KEYS:
            _close(f"phase 17a BERTScore {key} against 13e's plain route", np.asarray(sharded[key]), np.asarray(plain[key]), atol=ENC_RTOL)
        bert_stats = enc.compile_stats()
        if bert_stats.get("param_gather") != "in_program" or bert_stats["compiles"] < 1:
            raise AssertionError(f"phase 17a BERTScore: {bert_stats}")
        _log(
            f"phase 17a BERTScore, {len(preds)} pairs of 13a, the {BERT_LAYERS}-layer encoder as apply_fn(params, ids, mask)"
            f" with every 2-D weight split over mp and the sentences over dp: within {ENC_RTOL} of the plain route;"
            f" {len(preds) / sharded_s:.0f} pairs/s against {len(preds) / plain_s:.0f}; {bert_stats}; resident"
            f" {encoder_stats()['encoders'][enc.name]}; graph pool reserved {_mib(_graph_pool_bytes(torch))}; {smi}"
        )
        del enc
    finally:
        dist.destroy_process_group()
    engine.clear_cache()
    torch.cuda.empty_cache()


def _encoder_rank(rank: int, port: int, out_path: str) -> None:
    """One rank of phase 17b (this script run with ``--encoder-rank``): join
    the gloo world of four on ``cuda:0``, lay a ``(2, 2)`` mesh over it, run
    FID with ``encoder_sharding="mp"`` on its dp half of the images and
    BERTScore through the cut encoder on every pair, and save the results."""
    import torch
    import torch.distributed as dist
    from datetime import timedelta

    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import metrics_tpu_torch as mt
    import metrics_tpu_torch.functional as ft
    from metrics_tpu_torch.encoders import encoder_stats
    from metrics_tpu_torch.engine import _tree, clear_cache

    torch.cuda.set_device(0)
    _record_refusals()
    out_dir = os.path.dirname(out_path)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=SHARD_WORLD, rank=rank, timeout=timedelta(seconds=240)
    )
    rec = {"rank": rank}
    try:
        mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("dp", "mp"))
        dp, mp = mesh.get_local_rank("dp"), mesh.get_local_rank("mp")
        rec["coords"] = (dp, mp)
        real, fake = _cifar_sets(torch)
        m = ENC_MESH_IMAGES
        halves = {True: real[:m].chunk(2)[dp], False: fake[:m].chunk(2)[dp]}
        fid = mt.FrechetInceptionDistance(
            feature=2048, weights_path=os.path.join(out_dir, "inception.npz"), feature_sharding="mp", encoder_sharding="mp"
        )
        fid.shard_states(mesh)
        runtime = fid._encoder_runtime
        torch.cuda.reset_peak_memory_stats()
        _, rec["first_chunk_s"] = _timed(torch, lambda: fid.update_stream([halves[True][:ENC_MESH_CHUNK]], real=True))
        rest = {True: list(halves[True][ENC_MESH_CHUNK:].split(ENC_MESH_CHUNK)), False: list(halves[False].split(ENC_MESH_CHUNK))}
        t0 = time.perf_counter()
        fid.update_stream(rest[True], real=True)
        fid.update_stream(rest[False], real=False)
        torch.cuda.synchronize()
        rec["chunk_ms"] = 1e3 * (time.perf_counter() - t0) / (len(rest[True]) + len(rest[False]))
        rec["fid"] = float(fid.compute())
        rec["block"] = runtime(real[:ENC_BLOCK_IMAGES]).cpu()
        rec["record"] = encoder_stats()["encoders"]["inception_2048"]
        rec["stats"] = runtime.compile_stats()
        rec["kernel"] = tuple(runtime.params["Conv2d_1a_3x3"]["kernel"].shape)
        rec["pool_bytes"] = _graph_pool_bytes(torch)
        _, gather_s = _timed(torch, runtime._dispatch_params)  # gloo: gathered before each dispatch
        rec["gather_ms"] = gather_s * 1e3
        rec["fid_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del fid, runtime, real, fake, halves, rest
        clear_cache()
        torch.cuda.empty_cache()

        with open(os.path.join(out_dir, "pairs.json")) as f:
            preds, refs = json.load(f)
        enc = _bert_mesh_encoder(torch, mesh, ENC_MESH_LAYERS)
        scores, rec["bert_s"] = _timed(torch, lambda: ft.bert_score(preds, refs, model=enc, **_bert_kw()))
        rec["bert"] = {k: np.asarray(scores[k]) for k in BERT_KEYS}
        rec["bert_record"] = encoder_stats()["encoders"][enc.name]
        rec["bert_whole_bytes"] = sum(
            x.numel() * x.element_size() for x, layout in zip(_tree.flatten(enc.params)[0], enc._param_layouts) if layout is None
        )
        rec["bert_stats"] = enc.compile_stats()
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(rec, out_path)


def _encoder_mesh_ranks(torch, mt, ft, smi: str, path: str, pairs) -> None:
    """Phase 17b: four gloo ranks on ``cuda:0`` on a ``(2, 2)`` mesh, held
    against the unsharded routes run here afterwards."""
    from metrics_tpu_torch import engine
    from metrics_tpu_torch.encoders import ShardedEncoder
    from metrics_tpu_torch.image.fid import _inception_apply_for
    from metrics_tpu_torch.image.networks import inception as net

    preds, refs = (list(side[:ENC_MESH_PAIRS]) for side in pairs)
    with tempfile.TemporaryDirectory() as out_dir:
        shutil.copy(path, os.path.join(out_dir, "inception.npz"))
        with open(os.path.join(out_dir, "pairs.json"), "w") as f:
            json.dump([preds, refs], f)
        ranks = _run_shard_ranks(out_dir, flag="--encoder-rank", phase="17b", timeout_s=ENC_RANK_TIMEOUT_S)

    # the unsharded references on this process
    m = ENC_MESH_IMAGES
    real, fake = _cifar_sets(torch)
    whole = mt.FrechetInceptionDistance(feature=2048, weights_path=path, matrix_sqrt="newton_schulz")
    whole.update_stream(list(real[:m].split(ENC_MESH_CHUNK)), real=True)
    whole.update_stream(list(fake[:m].split(ENC_MESH_CHUNK)), real=False)
    want = float(whole.compute())
    ext = net.resolve_inception_extractor(2048, path)
    plain_runtime = ShardedEncoder(_inception_apply_for(ext.feature, ext.resize_input), ext.params, name="inception_2048_unsharded")
    features = plain_runtime(real[:ENC_BLOCK_IMAGES]).cpu()
    plain_bert = ft.bert_score(preds, refs, model=_bert_plain(torch, ENC_MESH_LAYERS), **_bert_kw())
    del whole, plain_runtime, real, fake
    engine.clear_cache()
    torch.cuda.empty_cache()
    values = {rec["fid"] for rec in ranks}
    if len(values) != 1:
        raise AssertionError(f"phase 17b: FID differs between the ranks: {sorted(values)}")
    (value,) = values
    if abs(value - want) > ENC_RTOL * abs(want):
        raise AssertionError(f"phase 17b: sharded FID {value!r} against the unsharded {want!r} (rtol {ENC_RTOL})")
    half = 2048 // 2
    for rec in ranks:
        dp, mp = rec["coords"]
        want_block = features[:, mp * half:(mp + 1) * half]
        if not torch_equal(rec["block"], want_block):
            err = float((rec["block"] - want_block).abs().max())
            raise AssertionError(f"phase 17b rank {rec['rank']}: the feature block differs from its slice of the unsharded features (max {err:.3e})")
        # every Inception leaf is split; the encoder's 1-D leaves (biases, norms) are whole on every rank
        inc, bert = rec["record"], rec["bert_record"]
        if inc["params_bytes_per_device"] * 2 != inc["params_bytes_total"] or inc["devices"] != SHARD_WORLD:
            raise AssertionError(f"phase 17b rank {rec['rank']}: Inception resident {inc}")
        split_total, split_local = (bert[k] - rec["bert_whole_bytes"] for k in ("params_bytes_total", "params_bytes_per_device"))
        odd_rows = 4 * BERT_FFN * (2 + 4 * ENC_MESH_LAYERS)  # at most a row more on one rank, per split leaf
        if abs(2 * split_local - split_total) > odd_rows or bert["devices"] != SHARD_WORLD:
            raise AssertionError(f"phase 17b rank {rec['rank']}: BERT encoder resident {bert}, whole leaves {rec['bert_whole_bytes']} B")
        if rec["stats"].get("param_gather") != "before_program" or rec["kernel"] != (16, 3, 3, 3):
            raise AssertionError(f"phase 17b rank {rec['rank']}: {rec['stats']}, Conv2d_1a_3x3 shard {rec['kernel']}")
        for key in BERT_KEYS:
            _close(f"phase 17b rank {rec['rank']} BERTScore {key}", rec["bert"][key], np.asarray(plain_bert[key]), atol=ENC_RTOL)
        _log(
            f"phase 17b rank {rec['rank']} (dp {dp}, mp {mp}): FID {value!r} on {m} + {m} images (its dp half streamed in"
            f" chunks of {ENC_MESH_CHUNK}) against the unsharded {want!r}; feature block [{ENC_BLOCK_IMAGES}, {half}] equals"
            f" its slice bit for bit; first chunk (warm-up, capture) {rec['first_chunk_s'] * 1e3:.0f} ms, then"
            f" {rec['chunk_ms']:.1f} ms per chunk; the gloo gather of the weights {rec['gather_ms']:.1f} ms; resident"
            f" {rec['record']}; graph pool reserved {_mib(rec['pool_bytes'])}; {rec['stats']}; peak {rec['fid_peak_gb']:.2f} GB;"
            f" BERTScore ({ENC_MESH_PAIRS} pairs, {ENC_MESH_LAYERS} layers at full width) within {ENC_RTOL} of the unsharded"
            f" route in {rec['bert_s']:.2f} s, resident {rec['bert_record']}, {rec['bert_stats']}; peak {rec['peak_gb']:.2f} GB"
        )


def run_encoder_mesh_phase(torch, mt, smi: str, pairs) -> None:
    """Phase 17: the encoder's mesh. (a) NCCL at world size 1 in this
    process; (b) four gloo ranks on ``cuda:0`` on a ``(2, 2)`` mesh."""
    import metrics_tpu_torch.functional as ft
    from metrics_tpu_torch.image.networks import inception as net

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_encoder_mesh_")
    try:
        path = os.path.join(tmp, "inception.npz")
        net.save_inception_weights(net.random_inception_params(seed=SEED, device="cuda"), path)
        _encoder_world_one(torch, mt, ft, smi, path, pairs)
        _log(f"phase 17a: {time.perf_counter() - t_phase:.1f} s")
        _encoder_mesh_ranks(torch, mt, ft, smi, path, pairs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _log(f"phase 17 encoder mesh: {time.perf_counter() - t_phase:.1f} s in all; {smi}")


# ---------------------------------------------------------------------------
# phase 18: the resilient sync on the card
# ---------------------------------------------------------------------------
RES_WORLD = 4
RES_SEED = 18
RES_RANK_TIMEOUT_S = 300
RES_TIMEOUT_S = 5.0  # the group deadline of the dropped-payload run
RES_PLANS = {  # launch -> METRICS_TPU_FAULTS of every rank ("" for none)
    "exact": "",
    "corrupt": '[{"kind": "corrupt", "rank": 1, "times": 2}]',
    "drop": '[{"kind": "drop", "rank": 3}]',
}
RES_MEMBERS = ("top1", "top5", "f1", "confmat")
RES_REPEATS = 3  # computes timed through the store and through gloo in run 1
PROBE_KEYS = ("total", "conf_bf16", "conf_exact")


def _wire_probe(mt, **kw):
    """The phase's own metric: the per-class sum of the logits (``[1000]``
    float32, tagged ``int8``) and two buffers of each sample's top-1 softmax
    confidence, one tagged ``bf16`` and one exact."""
    import torch

    class WireProbe(mt.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", default=torch.zeros(IMAGENET_VAL[1]), dist_reduce_fx="sum", sync_precision="int8")
            self.add_state("conf_bf16", default=[], dist_reduce_fx="cat", sync_precision="bf16")
            self.add_state("conf_exact", default=[], dist_reduce_fx="cat")

        def update(self, logits, confidence):
            self.total = self.total + logits.sum(0)
            self.conf_bf16.append(confidence)
            self.conf_exact.append(confidence)

        def compute(self):
            return {k: self.cat_state(k) if k != "total" else self.total for k in PROBE_KEYS}

    return WireProbe(**kw)


def _resilience_stream(torch):
    """Phase 18's ImageNet-1k val stream on the card from its own seed, with
    each sample's top-1 softmax confidence computed once over the whole
    stream (so every process holds the same bits)."""
    logits_np, target_np = _imagenet_stream(np.random.default_rng(RES_SEED), IMAGENET_VAL[0])
    logits, target = torch.from_numpy(logits_np).cuda(), torch.from_numpy(target_np).cuda()
    confidence = torch.softmax(logits, dim=1).amax(dim=1)
    return logits_np, target_np, {"preds": logits, "target": target, "confidence": confidence}


def _res_batches(rank: int):
    return _batches(IMAGENET_VAL[0])[rank::RES_WORLD]


def _stream_res(mc, probe, data, bounds) -> None:
    for s, e in bounds:
        mc(data["preds"][s:e], data["target"][s:e])
        probe.update(data["preds"][s:e], data["confidence"][s:e])


def _regroup(mt, objs, group, policy: str) -> None:
    """Every metric of ``objs`` syncs over ``group`` under ``policy``, and
    forgets its cached value."""
    for obj in objs:
        for m in obj.modules():
            if isinstance(m, mt.Metric):
                m.process_group, m.on_sync_error, m._computed = group, policy, None
                m._sync_stats = mt.resilience.new_sync_stats()


def _res_compute(torch, mt, mc, probe, repeats: int = 1):
    """The collection's and the probe's ``compute()``, ``repeats`` times
    (every rank the same count, so the exchanges stay aligned): the first
    values, the wall ms of each time, and the wire events."""
    times, values = [], None
    with mt.obs.capture() as events:
        for _ in range(repeats):
            for obj in (mc, probe):
                for m in obj.modules():
                    if isinstance(m, mt.Metric):
                        m._computed = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = {k: v for k, v in mc.compute().items()}
            got.update({f"probe.{k}": v for k, v in probe.compute().items()})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            values = got if values is None else values
    wire = [dict(e.data, source=e.source) for e in events if e.kind == "wire"]
    return {k: v.detach().cpu() for k, v in values.items()}, times, wire


def _ms_note(times) -> str:
    return f"first {times[0]:.1f} ms, median {sorted(times)[len(times) // 2]:.1f} ms" if len(times) > 1 else f"{times[0]:.1f} ms"


def _resilience_rank(rank: int, port: int, out_path: str, launch: str) -> None:
    """One rank of phase 18a (this script run with ``--resilience-rank``):
    join a gloo world of four over TCP loopback, stream this rank's quarter
    of the stream on ``cuda:0``, and sync through the store as ``launch``
    says (the fault plan, if any, is in ``METRICS_TPU_FAULTS``)."""
    import torch
    import torch.distributed as dist
    from datetime import timedelta

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.parallel import groups

    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=RES_WORLD, rank=rank, timeout=timedelta(seconds=120)
    )
    rec = {"launch": launch, "rank": rank}
    try:
        _, _, data = _resilience_stream(torch)
        mc, probe = _imagenet_collection(mt), _wire_probe(mt)
        bounds = _res_batches(rank)
        t0 = _reset_stats(torch, mt)
        _stream_res(mc, probe, data, bounds)
        seconds, stats = _read_stats(torch, mt, t0, {"select_topk": len(bounds), "confusion_counts": len(bounds)})
        rec["launches"] = {op: stats[op]["launches"] for op in ("select_topk", "confusion_counts")}
        rec["stream_s"] = seconds
        rec["local"] = {k: probe.cat_state(k).cpu() if k != "total" else probe.total.cpu() for k in PROBE_KEYS}
        policy = "partial" if launch == "drop" else "raise"
        timeout_s = RES_TIMEOUT_S if launch == "drop" else 60.0
        group = mt.parallel.new_group(range(RES_WORLD), name=f"phase18-{launch}", timeout_s=timeout_s)
        _regroup(mt, (mc, probe), group, policy)
        groups.reset_negotiation_stats()
        rec["store"], rec["store_ms"], rec["store_wire"] = _res_compute(
            torch, mt, mc, probe, repeats=RES_REPEATS if launch == "exact" else 1
        )
        rec["store_reports"] = {**{k: m.sync_report() for k, m in mc.items()}, "probe": probe.sync_report()}
        if launch == "exact":
            # the same ranks through the gloo collective path
            _regroup(mt, (mc, probe), None, "raise")
            rec["gloo"], rec["gloo_ms"], rec["gloo_wire"] = _res_compute(torch, mt, mc, probe, repeats=RES_REPEATS)
            # run 4: rank 3 is an old build that speaks wire v1 only
            v1 = mt.parallel.new_group(range(RES_WORLD), name="phase18-v1", timeout_s=60.0)
            _regroup(mt, (mc, probe), v1, "raise")
            groups.reset_negotiation_stats()
            with groups.speaking(1) if rank == 3 else contextlib.nullcontext():
                rec["v1"], rec["v1_ms"], rec["v1_wire"] = _res_compute(torch, mt, mc, probe)
            rec["v1_negotiation"] = groups.negotiation_stats()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(rec, out_path)


def _res_launch(out_dir: str, launch: str):
    """The four ranks of one launch, the plan in each rank's environment."""
    sub = os.path.join(out_dir, launch)
    os.makedirs(sub, exist_ok=True)
    env = dict(os.environ)
    env.pop("METRICS_TPU_FAULTS", None)
    if RES_PLANS[launch]:
        env["METRICS_TPU_FAULTS"] = RES_PLANS[launch]
    return _run_shard_ranks(
        sub, flag="--resilience-rank", phase=f"18a ({launch})", timeout_s=RES_RANK_TIMEOUT_S, extra=(launch,), env=env
    )


def _probe_oracles(torch, mt, recs, ranks):
    """For the ranks ``ranks``: the exact synced probe (the sum of their
    local sums, reduced on the card as a sync does, and the buffers in
    rank-major order), and the port's own round trip of each rank's leaf,
    reduced the same way."""
    from metrics_tpu_torch.parallel import comm, quantize

    def trip(x, codec):
        x = x.cuda()
        q, s, _ = quantize.quantize_array(x, codec)
        return quantize.dequantize_array(q, s, codec, x.dtype, tuple(x.shape))

    exact = {
        "total": comm.reduce_gathered([recs[r]["local"]["total"].cuda() for r in ranks], "sum").cpu(),
        "conf_bf16": torch.cat([recs[r]["local"]["conf_bf16"] for r in ranks]),
        "conf_exact": torch.cat([recs[r]["local"]["conf_exact"] for r in ranks]),
    }
    tripped = {
        "total": comm.reduce_gathered([trip(recs[r]["local"]["total"], "int8") for r in ranks], "sum").cpu(),
        "conf_bf16": torch.cat([trip(recs[r]["local"]["conf_bf16"], "bf16").cpu() for r in ranks]),
        "conf_exact": exact["conf_exact"],
    }
    # the int8 bound: each rank's leaf is off by at most its absmax / 254;
    # the sum of four adds float32 rounding (1e-6 of the magnitudes)
    bound = sum(quantize.error_bound("int8", float(recs[r]["local"]["total"].abs().max())) for r in ranks)
    bound += 1e-6 * float(sum(recs[r]["local"]["total"].abs() for r in ranks).max())
    return exact, tripped, bound


def _bits_equal(name: str, got, want) -> None:
    """The same dtype, shape and bits (floats compared as integers of their width)."""
    import torch

    same = got.shape == want.shape and got.dtype == want.dtype
    if same:
        a, b = got.detach().cpu().contiguous(), want.detach().cpu().contiguous()
        if a.is_floating_point():
            width = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
            a, b = a.view(width), b.view(width)
        same = torch.equal(a, b)
    if not same:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} differs bit for bit from {want.dtype}{tuple(want.shape)}")


def _check_probe(name: str, got: dict, exact: dict, tripped: dict, bound: float, quantized: bool = True) -> str:
    """The probe's synced leaves: the untagged buffer bit for bit; the
    tagged ones bit for bit against the round trips and within their bounds
    of the exact values (or, with ``quantized=False``, exact)."""
    _bits_equal(f"{name} conf_exact", got["probe.conf_exact"], exact["conf_exact"])
    if not quantized:
        _bits_equal(f"{name} total", got["probe.total"], exact["total"])
        _bits_equal(f"{name} conf_bf16", got["probe.conf_bf16"], exact["conf_bf16"])
        return "tagged leaves exact"
    _bits_equal(f"{name} total (int8)", got["probe.total"], tripped["total"])
    _bits_equal(f"{name} conf_bf16", got["probe.conf_bf16"], tripped["conf_bf16"])
    err_total = float((got["probe.total"].double() - exact["total"].double()).abs().max())
    conf = exact["conf_bf16"].double()
    err_conf = (got["probe.conf_bf16"].double() - conf).abs()
    if err_total > bound or bool((err_conf > conf.abs() * 2.0**-8).any()):
        raise AssertionError(f"{name}: tagged leaves outside their bounds ({err_total} > {bound}, or bf16 past 2^-8 relative)")
    return f"int8 sum err {err_total:.3g} <= {bound:.3g}, bf16 err <= 2^-8 relative (max {float(err_conf.max()):.3g})"


def _check_members(name: str, got: dict, oracle: dict) -> None:
    for key in RES_MEMBERS:
        _check_result(f"{name} {key}", got[key], oracle[key])


def _wire_ratios(name: str, wire: list) -> dict:
    ratios = {}
    for event in wire:
        ratio = event["bytes_encoded"] / event["bytes_raw"]
        ratios.setdefault(event["codec"], set()).add(round(ratio, 6))
    if ratios.get("bf16") != {0.5} or ratios.get("int8") != {0.254}:
        raise AssertionError(f"{name}: wire ratios {ratios}, expected bf16 0.5 and int8 0.254 (1000 codes + 4 scales / 4000)")
    return {k: sorted(v)[0] for k, v in ratios.items()}


def _world_one_probe(torch, mt, smi: str, data) -> str:
    """Phase 18b: the probe over the whole stream, synced through an NCCL
    group of one: the ``all_gather`` of its codes must give its local round
    trip bit for bit."""
    import torch.distributed as dist
    from metrics_tpu_torch.parallel import quantize

    probe = _wire_probe(mt)
    for s, e in _batches(IMAGENET_VAL[0]):
        probe.update(data["preds"][s:e], data["confidence"][s:e])
    local = {k: probe.cat_state(k) if k != "total" else probe.total for k in PROBE_KEYS}
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0, device_id=torch.device("cuda:0")
    )
    try:
        times = []
        for _ in range(SYNC_REPEATS):
            probe._computed = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = probe.compute()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        dist.destroy_process_group()
    for key, codec in (("total", "int8"), ("conf_bf16", "bf16"), ("conf_exact", "exact")):
        q, s, _ = quantize.quantize_array(local[key], codec)
        want = quantize.dequantize_array(q, s, codec, local[key].dtype, tuple(local[key].shape))
        _bits_equal(f"phase 18b NCCL {key}", got[key], want)
    report = probe.sync_report()
    if report["codec_counts"]["int8"] != SYNC_REPEATS or report["codec_counts"]["bf16"] != SYNC_REPEATS:
        raise AssertionError(f"phase 18b: sync_report {report}")
    return (
        f"phase 18b NCCL world size 1: the probe's compute() through all_gather of its codes equals its local round"
        f" trip bit for bit; compute() first {times[0]:.2f} ms, median {sorted(times)[len(times) // 2]:.2f} ms;"
        f" bytes raw {report['bytes_raw']} encoded {report['bytes_encoded']} over {SYNC_REPEATS} computes; {smi}"
    )


def run_resilience_phase(torch, mt, smi: str) -> dict:
    """Phase 18: the resilient sync. (a) Four gloo ranks on ``cuda:0`` sync
    through the store (``ProcessGroup``): run 1 exact with tagged leaves,
    beside the gloo collective path, and run 4 with rank 3 speaking wire v1
    (launch ``exact``); run 2 under corrupted reads of rank 1's payload
    (``corrupt``); run 3 with rank 3's payload dropped under
    ``on_sync_error="partial"`` (``drop``). (b) NCCL at world size 1 in this
    process. Returns the launches of the phase."""
    t_phase = time.perf_counter()
    logits_np, target_np, data = _resilience_stream(torch)
    oracle = _numpy_oracle(logits_np, target_np, IMAGENET_VAL[1])
    rows_012 = np.concatenate([np.arange(s, e) for r in range(3) for s, e in _res_batches(r)])
    oracle_012 = _numpy_oracle(logits_np[rows_012], target_np[rows_012], IMAGENET_VAL[1])
    with tempfile.TemporaryDirectory() as out_dir:
        launches = {launch: _res_launch(out_dir, launch) for launch in RES_PLANS}
    exact, tripped, bound = _probe_oracles(torch, mt, launches["exact"], range(RES_WORLD))
    exact_012, tripped_012, bound_012 = _probe_oracles(torch, mt, launches["exact"], range(3))
    # the untagged buffer of the one-process oracle: the stream's confidences in rank-major order
    rows_all = np.concatenate([np.arange(s, e) for r in range(RES_WORLD) for s, e in _res_batches(r)])
    _bits_equal("phase 18a one-process buffer", exact["conf_exact"], data["confidence"][torch.from_numpy(rows_all).cuda()])
    notes = []

    # run 1: exact reduce states, tagged leaves, on every rank; the gloo path gives the same bits
    run1 = launches["exact"]
    for rec in run1:
        r = rec["rank"]
        _check_members(f"phase 18a run 1 rank {r}", rec["store"], oracle)
        note = _check_probe(f"phase 18a run 1 rank {r}", rec["store"], exact, tripped, bound)
        for key, value in rec["store"].items():
            _bits_equal(f"phase 18a run 1 rank {r} {key} against rank 0", value, run1[0]["store"][key])
            _bits_equal(f"phase 18a run 1 rank {r} {key} gloo against the store", rec["gloo"][key], value)
        ratios = _wire_ratios(f"phase 18a run 1 rank {r}", rec["store_wire"])
        gloo_ratios = _wire_ratios(f"phase 18a gloo rank {r}", rec["gloo_wire"])
        for name, report in rec["store_reports"].items():
            if report["last_sync_outcome"] != "complete" or report["missing_ranks"] or report["retries"]:
                raise AssertionError(f"phase 18a run 1 rank {r} {name}: sync_report {report}")
    probe_report = run1[0]["store_reports"]["probe"]
    notes.append(f"run 1: {note}; wire ratios store {ratios}, gloo {gloo_ratios}")

    # run 2: corrupted reads of rank 1's payload are retried; the results are run 1's
    for rec in launches["corrupt"]:
        r = rec["rank"]
        for key, value in rec["store"].items():
            _bits_equal(f"phase 18a run 2 rank {r} {key} against run 1", value, run1[0]["store"][key])
        report = rec["store_reports"]["probe"]
        if r != 1 and (report["retries"] < 2 or report["integrity_failures"] < 2):
            raise AssertionError(f"phase 18a run 2 rank {r}: sync_report {report}")
        if report["last_sync_outcome"] != "complete":
            raise AssertionError(f"phase 18a run 2 rank {r}: sync_report {report}")
    corrupt_probe = launches["corrupt"][0]["store_reports"]["probe"]
    notes.append(
        f"run 2 (corrupt rank 1 x2): readers' probe retries {[rec['store_reports']['probe']['retries'] for rec in launches['corrupt']]},"
        f" integrity_failures {[rec['store_reports']['probe']['integrity_failures'] for rec in launches['corrupt']]},"
        f" backoff_s {corrupt_probe['backoff_s']:.3f}; results equal run 1 bit for bit"
    )

    # run 3: rank 3's payload dropped; ranks 0-2 reduce over themselves
    for rec in launches["drop"]:
        r = rec["rank"]
        for name, report in rec["store_reports"].items():
            want = ([3], 1, "partial") if r != 3 else ([], 0, "complete")
            got = (report["missing_ranks"], report["degraded_partial"], report["last_sync_outcome"])
            if got != want:
                raise AssertionError(f"phase 18a run 3 rank {r} {name}: {got}, expected {want}; {report}")
        if r == 3:
            for key, value in rec["store"].items():
                _bits_equal(f"phase 18a run 3 rank 3 {key} against run 1", value, run1[0]["store"][key])
            continue
        _check_members(f"phase 18a run 3 rank {r}", rec["store"], oracle_012)
        _check_probe(f"phase 18a run 3 rank {r}", rec["store"], exact_012, tripped_012, bound_012)
    drop_ms = [rec["store_ms"][0] for rec in launches["drop"]]
    notes.append(f"run 3 (drop rank 3, partial, {RES_TIMEOUT_S} s deadline): ranks 0-2 missing [3], equal the oracle over their batches; compute() ms {[f'{m:.0f}' for m in drop_ms]}")

    # run 4: rank 3 speaks v1 only; the group settles on v1 and the tagged leaves travel exact
    for rec in run1:
        r = rec["rank"]
        _check_members(f"phase 18a run 4 rank {r}", rec["v1"], oracle)
        _check_probe(f"phase 18a run 4 rank {r}", rec["v1"], exact, tripped, bound, quantized=False)
        nego = rec["v1_negotiation"]
        if nego["negotiations"] != 5 or nego["fallback_exact"] != 1 or nego["capped"] != (0 if r == 3 else 5):
            raise AssertionError(f"phase 18a run 4 rank {r}: negotiation_stats {nego}")
        if rec["v1_wire"]:
            raise AssertionError(f"phase 18a run 4 rank {r}: quantized payloads {rec['v1_wire']}")
    notes.append(f"run 4 (rank 3 speaks v1): negotiation_stats {run1[0]['v1_negotiation']} on rank 0, tagged leaves exact")

    note_b = _world_one_probe(torch, mt, smi, data)
    for rec in run1:
        rep = rec["store_reports"]["probe"]
        sent = sum(r["bytes_sent"] for r in rec["store_reports"].values()) // RES_REPEATS
        _log(
            f"phase 18a rank {rec['rank']} ({len(_res_batches(rec['rank']))} batches in {rec['stream_s']:.2f} s,"
            f" launches {rec['launches']}): compute() of the collection and the probe through the store"
            f" {_ms_note(rec['store_ms'])}, through gloo {_ms_note(rec['gloo_ms'])}, store with rank 3 on v1"
            f" {_ms_note(rec['v1_ms'])}; bytes sent through the store a compute {sent}, the probe's {rep['bytes_sent']}"
            f" (raw {rep['bytes_raw']}, encoded {rep['bytes_encoded']}), backoff_s {rep['backoff_s']};"
            f" run 2 {_ms_note(launches['corrupt'][rec['rank']]['store_ms'])}, backoff_s"
            f" {launches['corrupt'][rec['rank']]['store_reports']['probe']['backoff_s']:.3f};"
            f" run 3 {_ms_note(launches['drop'][rec['rank']]['store_ms'])}; {smi}"
        )
    for note in notes:
        _log(f"phase 18a {note}")
    _log(note_b)
    _log(
        f"phase 18 resilience: {time.perf_counter() - t_phase:.1f} s in all (3 launches of 4 ranks);"
        f" probe sync_report on rank 0 run 1: {probe_report}; {smi}"
    )
    return {
        op: sum(rec["launches"][op] for recs in launches.values() for rec in recs)
        for op in ("select_topk", "confusion_counts")
    }


SERVE_SEED = 19
SERVE_REQ = 64  # rows of one serving request
SERVE_BANK = (512, 2, 256)  # 19a: tenants (the bank's capacity), requests each, the router's max_requests
SERVE_SOLO_CHECK = 16  # 19a: tenants also held against a solo collection bit for bit
SERVE_CHURN = (16, 32, 4, 6)  # 19b: capacity, tenants, rounds, the wave after which the child kills itself
SERVE_CHILD_TIMEOUT_S = 300
SERVE_AUDIT = (8, 8, 4)  # 19c: tenants (the capacity), waves, the audit period (audit_rate=1/4)
SERVE_FLIP_SEQ = 5


def _serving_stream(n: int):
    """The phase's seeded ImageNet-1k-shaped stream of ``n`` rows."""
    return _imagenet_stream(np.random.default_rng(SERVE_SEED), n)


def _tenant_rows(tenant: int, requests, tenants: int) -> np.ndarray:
    """The rows of ``tenant``'s requests: request ``r`` of tenant ``t`` is
    block ``r * tenants + t`` of ``SERVE_REQ`` rows."""
    return np.concatenate([np.arange((r * tenants + tenant) * SERVE_REQ, (r * tenants + tenant + 1) * SERVE_REQ) for r in requests])


def _check_tenant(name: str, got: dict, logits_np, target_np, rows) -> None:
    """One collection tenant against the numpy oracle over its rows: counts
    bit for bit, scores within 1e-6 relative."""
    oracle = _numpy_oracle(logits_np[rows], target_np[rows], IMAGENET_VAL[1])
    for key, want in oracle.items():
        _check_result(f"{name} {key}", got[key], want)


def _launches(stats) -> dict:
    return {op: rec["launches"] for op, rec in stats.items() if rec["launches"]}


def run_bank_phase(torch, mt, smi: str) -> dict:
    """Phase 19a: a resident collection bank at ImageNet width; returns its
    launches. The bank's graphs are its own: dropping it frees them and
    their memory pool."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from metrics_tpu_torch.engine import cache
    from metrics_tpu_torch.serving import MetricBank, RequestRouter

    tenants, per, max_req = SERVE_BANK
    n = tenants * per * SERVE_REQ
    logits_np, target_np = _serving_stream(n)
    logits, target = torch.from_numpy(logits_np).cuda(), torch.from_numpy(target_np).cuda()
    baseline = torch.cuda.memory_allocated()  # what this process holds without the bank
    bank = MetricBank(_imagenet_collection(mt), capacity=tenants, name="smoke19a")
    bank_entry = cache.collection_bank_entry(bank._member_keys, bank._members)  # holds no reference to the bank
    entry_before = bank_entry.summary()
    router = RequestRouter(bank, max_requests=max_req, max_delay_s=None)
    waves = [(r, range(s, s + max_req)) for r in range(per) for s in range(0, tenants, max_req)]

    def submit(r, group):
        flushed = 0
        for t in group:
            s = (r * tenants + t) * SERVE_REQ
            flushed += router.submit(t, logits[s:s + SERVE_REQ], target[s:s + SERVE_REQ])
        if flushed != len(group):
            raise AssertionError(f"phase 19a: {flushed} requests flushed by a wave of {len(group)}")

    t0 = _reset_stats(torch, mt)
    torch.cuda.reset_peak_memory_stats()
    wall, host_ms, syncs = [], [], []
    rows = []
    for i, (r, group) in enumerate(waves):
        torch.cuda.synchronize()
        t_w = time.perf_counter()
        if i == 0:
            submit(r, group)
        elif i < len(waves) - 1:
            syncs.append(_host_syncs(torch, lambda r=r, group=group: submit(r, group)))
        else:  # the last wave under the profiler: its device time and device operations
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                syncs.append(_host_syncs(torch, lambda r=r, group=group: submit(r, group)))
                torch.cuda.synchronize()
            rows = _device_rows(prof)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t_w) * 1e3)
        host_ms.append(bank._last_flush_ms)
    peak = torch.cuda.max_memory_allocated() - baseline  # the bank's, its waves' and its graph pool's
    pool_id = bank._resident.pool
    pool = _graph_pool_bytes(torch, pool_id)
    # the capture's warm-up runs one request; every wave is then a replay
    per_kernel = len(waves) * max_req + 1
    seconds, stats = _read_stats(torch, mt, t0, {"select_topk": per_kernel, "confusion_counts": per_kernel})
    if bank.stats["launches"] != len(waves) or bank.stats["requests"] != tenants * per:
        raise AssertionError(f"phase 19a: bank stats {bank.stats}")
    if any(syncs):
        raise AssertionError(f"phase 19a: host syncs per replayed wave {syncs}")
    entry = _engine_delta(entry_before, bank_entry.summary())
    if entry["graphs"] != 1 or entry["failed_captures"] or entry["cache_hits"] != len(waves) - 1:
        raise AssertionError(f"phase 19a: the wave program was not one replayed capture: {entry}; refusals {_REFUSALS[-3:]}")
    bank_bytes = sum(t.numel() * t.element_size() for t in bank._resident.values())
    if pool is None or peak > 1.5 * bank_bytes + pool:
        raise AssertionError(f"phase 19a: peak {peak / 1e9:.2f} GB against 1.5 x the bank {bank_bytes / 1e9:.2f} GB + the graph pool {_mib(pool)}")
    dev_ms = sum(r["device_us"] for r in rows) / 1e3 if rows else None
    dev_ops = sum(r["calls"] for r in rows) if rows else None

    # every tenant against the numpy oracle, then one coalesced fetch of all
    t_c = time.perf_counter()
    values = bank.compute_many(range(tenants))
    torch.cuda.synchronize()
    many_s = time.perf_counter() - t_c
    for t in range(tenants):
        _check_tenant(f"phase 19a tenant {t}", values[t], logits_np, target_np, _tenant_rows(t, range(per), tenants))
    t_c = time.perf_counter()
    fetched = bank.compute_async(list(range(tenants))).result()
    async_s = time.perf_counter() - t_c
    for t in range(tenants):
        for key, v in values[t].items():
            if not torch_equal(fetched[t][key], v.cpu()):
                raise AssertionError(f"phase 19a compute_async tenant {t} {key} differs from compute_many")

    # the same traffic through solo collections; some of them bit for bit against the bank
    solos = [_imagenet_collection(mt) for _ in range(tenants)]
    solo_s = []
    for r in range(per):
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        for t in range(tenants):
            s = (r * tenants + t) * SERVE_REQ
            solos[t].update(logits[s:s + SERVE_REQ], target[s:s + SERVE_REQ])
        torch.cuda.synchronize()
        solo_s.append(time.perf_counter() - t_s)
    for t in range(SERVE_SOLO_CHECK):
        want = solos[t].compute()
        for key, v in values[t].items():
            if not torch_equal(v, want[key]):
                raise AssertionError(f"phase 19a tenant {t} {key}: the bank differs from a solo collection")
    _require_programs("phase 19a solo collection", solos[-1])
    del solos
    dev = "not measured" if dev_ms is None else f"{dev_ms:.2f} ms device, {dev_ops} device operations (wave {len(waves)}, profiled)"
    _log(
        f"phase 19a bank: {tenants} tenants x {per} requests of [{SERVE_REQ}, {IMAGENET_VAL[1]}] through"
        f" RequestRouter(max_requests={max_req}) in {len(waves)} waves, {seconds:.2f} s: every tenant equals the numpy"
        f" oracle, {SERVE_SOLO_CHECK} equal solo collections bit for bit, compute_async equals compute_many; ms per wave"
        f" wall {[round(w, 1) for w in wall]} (wave 1: a one-request warm-up, the capture and a replay; wave {len(waves)}: under the profiler),"
        f" host (apply_batch) {[round(h, 1) for h in host_ms]}; {dev}; host syncs per replayed wave {syncs};"
        f" {max_req / (wall[2] / 1e3):.0f} requests/s banked (wave 3) against {tenants / solo_s[1]:.0f} requests/s for"
        f" {tenants} solo collections (their second round; the first, each one's eager probe: {tenants / solo_s[0]:.0f}/s);"
        f" bank entry {entry}; peak {peak / 1e9:.2f} GB over the {baseline / 1e9:.2f} GB held before the bank"
        f" <= 1.5 x the bank's {bank_bytes / 1e9:.2f} GB + the graph pool {_mib(pool)}; compute_many {many_s:.2f} s,"
        f" compute_async (one fetch) {async_s:.2f} s; launches {_launches(stats)}; {smi}"
    )
    # no clear_cache(): the bank's graphs and their pool go with the bank
    reserved = torch.cuda.memory_reserved()
    del bank, router, values, fetched, submit
    gc.collect()
    torch.cuda.empty_cache()
    left = _graph_pool_bytes(torch, pool_id)
    graphs_left = bank_entry.summary()["graphs"] - entry_before["graphs"]
    freed = reserved - torch.cuda.memory_reserved()
    if left or graphs_left or freed < pool:
        raise AssertionError(
            f"phase 19a: after del bank the graph pool holds {_mib(left)} ({graphs_left} graphs left), and"
            f" {_mib(freed)} of the {_mib(pool)} pool came back to the card"
        )
    _log(f"phase 19a bank dropped: its {_mib(pool)} graph pool released, {_mib(freed)} reserved memory freed; {smi}")
    return _launches(stats)


# -- 19b: spill churn and kill -9 --------------------------------------------
_CHILD_TIMED = (
    ("digest", "metrics_tpu_torch.resilience.integrity", "leaf_digest"),
    ("encode", "metrics_tpu_torch.parallel.groups", "_encode_with_codec"),
    ("decode", "metrics_tpu_torch.parallel.groups", "_decode"),
)


def _time_into(seconds: dict, key: str, owner, name: str) -> None:
    fn = getattr(owner, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0

    setattr(owner, name, timed)


def _serving_child(root: str, ack_path: str) -> None:
    """19b's serving process (``--serving-child``): the collection bank over
    a ``DiskStore``, 32 sessions round-robin through a router of 16, an
    acknowledgement appended after every applied wave, and a ``SIGKILL``
    of itself after wave 6. Writes its timings beside the store first."""
    import importlib
    import signal

    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.serving import DiskStore, MetricBank, RequestRouter

    capacity, tenants, rounds, kill_after = SERVE_CHURN
    seconds: dict = {}
    for key, module, name in _CHILD_TIMED:
        _time_into(seconds, key, importlib.import_module(module), name)
    for name in ("put", "get", "append_journal_many", "rewrite_journal"):
        _time_into(seconds, "io", DiskStore, name)
    _time_into(seconds, "fetch", MetricBank, "_fetch_rows")
    _time_into(seconds, "readmit", MetricBank, "_decode_spilled")
    write_s = {"spill": 0.0, "checkpoint": 0.0}
    write = MetricBank._write_tenant_blob

    def timed_write(self, tenant, tree, count, op, defer_journal=False):
        t0 = time.perf_counter()
        try:
            return write(self, tenant, tree, count, op, defer_journal)
        finally:
            write_s[op] = write_s.get(op, 0.0) + time.perf_counter() - t0

    MetricBank._write_tenant_blob = timed_write
    logits_np, target_np = _serving_stream(tenants * rounds * SERVE_REQ)
    logits, target = torch.from_numpy(logits_np).cuda(), torch.from_numpy(target_np).cuda()
    bank = MetricBank(_imagenet_collection(mt), capacity=capacity, spill_store=DiskStore(root), checkpoint_every_n_flushes=1, name="smoke19")
    router = RequestRouter(bank, max_requests=capacity, max_delay_s=None)
    wave, wave_ms, t_w = 0, [], time.perf_counter()
    for r in range(rounds):
        for t in range(tenants):
            s = (r * tenants + t) * SERVE_REQ
            if not router.submit(t, logits[s:s + SERVE_REQ], target[s:s + SERVE_REQ]):
                continue
            torch.cuda.synchronize()
            wave += 1
            wave_ms.append((time.perf_counter() - t_w) * 1e3)
            t_w = time.perf_counter()
            record = {
                "waves": wave, "wave_ms": wave_ms, "seconds": seconds, "write_s": write_s, "stats": dict(bank.stats),
                "durability": mt.serving.durability_stats(), "launches": _launches(mt.kernel_stats()),
                "plain_calls": sum(rec["plain_calls"] for rec in mt.kernel_stats().values()),
            }
            with open(os.path.join(os.path.dirname(ack_path), "child_stats.json"), "w") as f:
                json.dump(record, f)
            with open(ack_path, "a") as f:
                f.write(f"{wave}\n")
                f.flush()
                os.fsync(f.fileno())
            if wave == kill_after:
                os.kill(os.getpid(), signal.SIGKILL)
    raise AssertionError(f"phase 19b child: the stream ended after {wave} waves")


def run_churn_phase(torch, mt, smi: str) -> dict:
    """Phase 19b: spill churn in a serving child, ``kill -9``, recovery here.
    Returns the child's launches."""
    from metrics_tpu_torch.serving import DiskStore, MetricBank, durability_stats
    from metrics_tpu_torch.serving.store import reset_durability_stats

    capacity, tenants, rounds, kill_after = SERVE_CHURN
    logits_np, target_np = _serving_stream(tenants * rounds * SERVE_REQ)
    acked_rounds = kill_after * capacity // tenants
    with tempfile.TemporaryDirectory() as tmp:
        root, ack = os.path.join(tmp, "store"), os.path.join(tmp, "acks")
        t_c = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--serving-child", root, ack],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        try:
            out, _ = proc.communicate(timeout=SERVE_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            raise AssertionError(f"phase 19b: the serving child ran past {SERVE_CHILD_TIMEOUT_S} s: {out[-3000:]}")
        child_s = time.perf_counter() - t_c
        if proc.returncode != -9:
            raise AssertionError(f"phase 19b: the serving child ended with {_exit_note(proc.returncode)}: {out[-3000:]}")
        with open(ack) as f:
            acks = [int(x) for x in f.read().split()]
        if acks != list(range(1, kill_after + 1)):
            raise AssertionError(f"phase 19b: acknowledged waves {acks}")
        with open(os.path.join(tmp, "child_stats.json")) as f:
            child = json.load(f)
        # one warm-up request ahead of the capture, then 6 replayed waves of 16
        want = {"confusion_counts": kill_after * capacity + 1, "select_topk": kill_after * capacity + 1}
        if child["launches"] != want or child["plain_calls"]:
            raise AssertionError(f"phase 19b: the child's launches {child['launches']}, expected {want}; plain calls {child['plain_calls']}")
        disk_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
        reset_durability_stats()
        torch.cuda.synchronize()
        t_r = time.perf_counter()
        bank = MetricBank.recover(_imagenet_collection(mt), capacity, DiskStore(root), name="smoke19")
        recover_s = time.perf_counter() - t_r
        t_r = time.perf_counter()
        values = {t: bank.compute(t) for t in range(tenants)}
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t_r
        if sorted(bank.spilled_tenants) != list(range(tenants)):
            raise AssertionError(f"phase 19b: recovered sessions {sorted(bank.spilled_tenants)}")
        for t in range(tenants):
            if bank.update_count(t) != acked_rounds:
                raise AssertionError(f"phase 19b tenant {t}: {bank.update_count(t)} updates recovered, {acked_rounds} acknowledged")
            _check_tenant(f"phase 19b tenant {t}", values[t], logits_np, target_np, _tenant_rows(t, range(acked_rounds), tenants))
        stats = durability_stats()
        if stats["recovers"] != 1 or stats["recovered_tenants"] != tenants:
            raise AssertionError(f"phase 19b: durability_stats {stats}")
    d, sec, w = child["durability"], child["seconds"], child["write_s"]
    writes = max(d["spill_writes"], 1)
    spills, checkpoints, readmits = child["stats"]["spills"], d["spill_writes"] - child["stats"]["spills"], child["stats"]["readmits"]
    per = lambda k: f"{sec.get(k, 0.0) * 1e3 / writes:.1f}"  # noqa: E731
    _log(
        f"phase 19b churn: a child served {tenants} sessions through MetricBank(capacity={capacity}, DiskStore,"
        f" checkpoint_every_n_flushes=1) in waves of {capacity}, acknowledged waves {acks} and was SIGKILLed"
        f" ({child_s:.1f} s in all, its start included); ms per wave {[round(x) for x in child['wave_ms']]};"
        f" {spills} spills ({w['spill'] * 1e3 / max(spills, 1):.1f} ms a tenant), {checkpoints} checkpoint writes"
        f" ({w['checkpoint'] * 1e3 / max(checkpoints, 1):.1f} ms a tenant), {readmits} readmits"
        f" ({sec.get('readmit', 0.0) * 1e3 / max(readmits, 1):.1f} ms a tenant, decode and digest checks); per tenant"
        f" write: digest {per('digest')} ms, encode {per('encode')} ms, I/O {per('io')} ms, row fetch {per('fetch')} ms"
        f" (the digest time counts every leaf digest: the payload's, the journal's and the readmits' checks);"
        f" {d['spill_bytes'] / 1e6:.0f} MB of blobs written, {disk_bytes / 1e6:.0f} MB on disk at the kill;"
        f" recover() {recover_s:.2f} s, then {tenants} tenants decoded and computed in {decode_s:.2f} s, each equal"
        f" to the numpy oracle over its {acked_rounds} acknowledged requests; durability_stats {stats}; the child's"
        f" launches {child['launches']}; {smi}"
    )
    return child["launches"]


# -- 19c: audits and silent corruption ----------------------------------------
def run_audit_phase(torch, mt, smi: str) -> dict:
    """Phase 19c: shadow audits catch a bitflip and repair it; a forged
    blob fails its readmission. Returns the phase's launches."""
    from metrics_tpu_torch.resilience import integrity
    from metrics_tpu_torch.serving import MetricBank
    from metrics_tpu_torch.utils.exceptions import StateIntegrityError

    tenants, waves, period = SERVE_AUDIT
    c = IMAGENET_VAL[1]
    logits_np, target_np = _serving_stream(tenants * waves * SERVE_REQ)
    logits, target = torch.from_numpy(logits_np).cuda(), torch.from_numpy(target_np).cuda()
    bank = MetricBank(mt.ConfusionMatrix(num_classes=c), capacity=tenants, audit_rate=1.0 / period, checkpoint_every_n_flushes=1, name="smoke19c")
    integrity.reset_integrity_stats()
    # the shadow audit checks the transition of the flush it samples, so
    # the flip lands inside a sampled flush (after its checkpoint): the
    # last wave, whose sample is the wave's second tenant
    victim = (waves // period - 1) % tenants
    sites = []
    t0 = _reset_stats(torch, mt)
    for w in range(waves):
        if w == waves - 1:
            bank.state_fault_injector = lambda ts: sites.append(integrity.inject_bitflip(bank, ts[victim], seq=SERVE_FLIP_SEQ))
        bank.apply_batch([(t, (logits[(w * tenants + t) * SERVE_REQ:(w * tenants + t + 1) * SERVE_REQ], target[(w * tenants + t) * SERVE_REQ:(w * tenants + t + 1) * SERVE_REQ])) for t in range(tenants)])
    bank.state_fault_injector = None
    seconds, stats = _read_stats(torch, mt, t0, {"confusion_counts": tenants * waves + 1})  # and the warm-up's request
    auditor = integrity.IntegrityAuditor(bank, repair=True)
    t_a = time.perf_counter()
    verdict = auditor.poll()
    audit_s = time.perf_counter() - t_a
    if verdict != {"checked": waves // period, "passed": waves // period - 1, "failed": 1, "repaired": 1} or auditor.last_failure["tenant"] != victim:
        raise AssertionError(f"phase 19c: audit verdict {verdict}, last failure {auditor.last_failure}, flipped {sites}")
    for t in range(tenants):
        rows = _tenant_rows(t, range(waves), tenants)
        want = _numpy_oracle(logits_np[rows], target_np[rows], c)["confmat"]
        _check_result(f"phase 19c tenant {t} confmat", bank.compute(t), want)
    # a forged blob: every crc valid, the digest wrong
    spilled = (victim + 1) % tenants
    bank.evict(spilled)
    key = bank._blob_key(spilled)
    bank.store.put(key, integrity.forge_payload_corruption(bank.store.get(key)))
    try:
        bank.admit(spilled)
    except StateIntegrityError as err:
        forged_note = f"readmission raised StateIntegrityError (leaf {err.leaf!r})"
    else:
        raise AssertionError("phase 19c: a forged blob was readmitted")
    _log(
        f"phase 19c audits: ConfusionMatrix(num_classes={c}) bank of {tenants} tenants, {waves} waves, audit_rate=1/{period},"
        f" checkpoint_every_n_flushes=1 ({seconds:.2f} s): a bitflip {sites} in wave {waves}; IntegrityAuditor.poll()"
        f" {verdict} in {audit_s * 1e3:.0f} ms reports tenant {auditor.last_failure['tenant']} (leaf"
        f" {auditor.last_failure['leaf']!r}), repaired: every tenant equals the oracle; a forged spilled blob: {forged_note};"
        f" integrity_stats {integrity.integrity_stats()}; {smi}"
    )
    return _launches(stats)


# -- 19d and 19e: the bank drive, and sync_bank_states at world size one --------
def run_bank_drive_phase(torch, mt, smi: str, logits, target, main_top5) -> dict:
    """Phase 19d: ``MetricBank.drive`` over ImageNet-1k val, against the same
    tenant fed per flush and the main path's top-5; then 19e over its bank.
    Returns the drive's launches."""
    from metrics_tpu_torch.engine import cache

    c = IMAGENET_VAL[1]
    batches = [(logits[s:e], target[s:e]) for s, e in _batches(IMAGENET_VAL[0])]
    steps = mt.engine.next_pow2(len(batches))
    driven = mt.serving.MetricBank(mt.Accuracy(num_classes=c, top_k=TOP_K, jit_bucket="pow2"), capacity=4, name="smoke19d")
    t0 = _reset_stats(torch, mt)
    times = []
    for tenant in ("e", "e2"):  # the first drive warms up and captures, the second replays
        torch.cuda.synchronize()
        t_d = time.perf_counter()
        mt.engine.drive_bank(driven, tenant, batches)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t_d) * 1e3)
    # a step a drive, the warm-up's one step, and the pad correction's
    # one-row update, computed once eagerly and kept
    seconds, stats = _read_stats(torch, mt, t0, {"select_topk": 2 * steps + 2})
    entry = cache.bank_drive_entry(driven._template).summary()
    if entry["graphs"] != 1 or entry["failed_captures"] or entry["cache_hits"] != 1 or driven.stats["launches"] != 2:
        raise AssertionError(f"phase 19d: the drive did not run captured: {entry}, bank stats {driven.stats}; refusals {_REFUSALS[-3:]}")
    flushed = mt.serving.MetricBank(mt.Accuracy(num_classes=c, top_k=TOP_K, jit_bucket="pow2"), capacity=4, name="smoke19d_flush")
    torch.cuda.synchronize()
    t_f = time.perf_counter()
    for b in batches:
        flushed.update("e", *b)
    torch.cuda.synchronize()
    flush_ms = (time.perf_counter() - t_f) * 1e3
    for tenant in ("e", "e2"):
        got, want = driven.tenant_state(tenant), flushed.tenant_state("e")
        for name, v in want.items():
            if not torch_equal(got[name], v):
                raise AssertionError(f"phase 19d {tenant} {name}: the drive differs from the per-flush bank")
    value = driven.compute("e")
    if not torch_equal(value, main_top5):
        raise AssertionError(f"phase 19d: drive top-5 {float(value)!r} against the main path's {float(main_top5)!r}")
    sync_note = _bank_sync_world_one(torch, driven, smi)
    _log(
        f"phase 19d bank drive: Accuracy(top_k={TOP_K}, jit_bucket='pow2') over ImageNet-1k val in {len(batches)}"
        f" batches (the ragged {RAGGED} padded to {BATCH}, {steps - len(batches)} no-op step): bit for bit the per-flush"
        f" bank and the main path's top-5 {float(value):.6f}; ms per drive {[round(t, 2) for t in times]} (first: a one-step"
        f" warm-up, the capture and a replay) against {flush_ms:.2f} ms for {len(batches)} flushes; entry {entry}; launches"
        f" {_launches(stats)} ({steps} a drive, 1 the warm-up's step, 1 the pad correction's zero row); {smi}"
    )
    _log(sync_note)
    return _launches(stats)


def _bank_sync_world_one(torch, bank, smi: str) -> str:
    """Phase 19e: ``sync_bank_states`` through NCCL at world size one on a
    ``(1,)`` ``("dp",)`` mesh: the leaves come back bit for bit, one
    all-reduce per leaf."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from metrics_tpu_torch.parallel import comm

    before = {n: v.clone() for n, v in bank._bank.items()}
    calls = []
    all_reduce = comm._all_reduce

    def counted(x, fx, group):
        calls.append(fx)
        return all_reduce(x, fx, group)

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0, device_id=torch.device("cuda:0"))
    comm._all_reduce = counted
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("dp",))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bank.sync_state_in_trace("dp", mesh=mesh)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        comm._all_reduce = all_reduce
        dist.destroy_process_group()
    for n, v in bank._bank.items():
        if not torch_equal(v, before[n]):
            raise AssertionError(f"phase 19e: leaf {n} changed through a world of one")
    if len(calls) != len(before):
        raise AssertionError(f"phase 19e: {len(calls)} all-reduces for {len(before)} leaves")
    return (
        f"phase 19e sync_bank_states: NCCL world size 1, ('dp',) mesh: {len(calls)} all-reduces {calls}, every leaf"
        f" bit for bit, {ms:.2f} ms; {smi}"
    )


# -- 19f: a refused capture -----------------------------------------------------
def run_refused_capture_phase(torch, mt, smi: str) -> dict:
    """Phase 19f: a wave whose capture the card refuses leaves the bank as it
    was, and the bank serves on. A ``ConfusionMatrix`` bank of 4 tenants takes
    a captured wave; a wave of a new signature (2 requests) whose update waits
    for the card, which a capture refuses, is tried twice; then the first
    signature's graph replays. Returns the phase's launches."""
    from metrics_tpu_torch.engine import cache
    from metrics_tpu_torch.serving import MetricBank
    from metrics_tpu_torch.utils.exceptions import JitIncompatibleError

    c, tenants = IMAGENET_VAL[1], 4
    logits_np, target_np = _serving_stream(3 * tenants * SERVE_REQ)
    logits, target = torch.from_numpy(logits_np).cuda(), torch.from_numpy(target_np).cuda()

    def requests(w, group):
        blocks = [((w * tenants + t) * SERVE_REQ, (w * tenants + t + 1) * SERVE_REQ) for t in group]
        return [(t, (logits[s:e], target[s:e])) for t, (s, e) in zip(group, blocks)]

    bank = MetricBank(mt.ConfusionMatrix(num_classes=c), capacity=tenants, name="smoke19f")
    entry = cache.bank_entry(bank._template)
    entry_before = entry.summary()
    t0 = _reset_stats(torch, mt)
    bank.apply_batch(requests(0, range(tenants)))
    rows = {n: v.clone() for n, v in bank._resident.items()}
    counts = {t: bank.update_count(t) for t in range(tenants)}
    inner = bank._template._inner_update

    def waits_for_the_card(*args, **kwargs):
        torch.cuda.synchronize()  # a host wait: fine eagerly, refused inside a capture
        return inner(*args, **kwargs)

    bank._template._inner_update = waits_for_the_card
    errors = []
    for attempt in (1, 2):
        try:
            bank.apply_batch(requests(1, range(2)))
        except JitIncompatibleError as err:
            errors.append(f"{type(err.__cause__ or err).__name__}: {str(err)[:160]}")
        else:
            raise AssertionError(f"phase 19f: try {attempt} of the wave whose capture is refused was applied")
        for n, v in bank._resident.items():
            if not torch_equal(v, rows[n]):
                raise AssertionError(f"phase 19f: try {attempt}: the refused wave changed the bank's {n!r}")
        if {t: bank.update_count(t) for t in range(tenants)} != counts or bank.stats["flush_errors"] != attempt:
            raise AssertionError(f"phase 19f: try {attempt}: counts {bank._counts}, stats {bank.stats}")
    bank._template._inner_update = inner
    bank.apply_batch(requests(2, range(tenants)))
    # wave 1's warm-up request and replay, the refused wave's warm-up request, wave 3's replay
    seconds, stats = _read_stats(torch, mt, t0, {"confusion_counts": 2 * tenants + 2})
    delta = _engine_delta(entry_before, entry.summary())
    if delta["graphs"] != 1 or delta["failed_captures"] != 1 or delta["cache_hits"] != 1:
        raise AssertionError(f"phase 19f: bank entry {delta}")
    for t in range(tenants):
        r = np.concatenate([np.arange((w * tenants + t) * SERVE_REQ, (w * tenants + t + 1) * SERVE_REQ) for w in (0, 2)])
        _check_result(f"phase 19f tenant {t} confmat", bank.compute(t), _numpy_oracle(logits_np[r], target_np[r], c)["confmat"])
    _log(
        f"phase 19f refused capture: ConfusionMatrix(num_classes={c}) bank of {tenants}; a wave of 2 whose update"
        f" waits for the card raised twice ({errors[0]}; then {errors[1]}), each time leaving every row, the sink"
        f" row and the counts bit for bit as they were; the next wave replayed and every tenant equals the oracle"
        f" over its 2 applied requests ({seconds:.2f} s); bank entry {delta}; launches {_launches(stats)}; {smi}"
    )
    return _launches(stats)


def run_serving_phase(torch, mt, smi: str, logits, target, main_top5) -> dict:
    """Phase 19: the serving plane (19a-19f); returns its launches per kernel."""
    t_phase = time.perf_counter()
    launches: dict = {}
    for part in (
        lambda: run_bank_phase(torch, mt, smi),
        lambda: run_churn_phase(torch, mt, smi),
        lambda: run_audit_phase(torch, mt, smi),
        lambda: run_bank_drive_phase(torch, mt, smi, logits, target, main_top5),
        lambda: run_refused_capture_phase(torch, mt, smi),
    ):
        for op, n in part().items():
            launches[op] = launches.get(op, 0) + n
    _log(f"phase 19 serving: {time.perf_counter() - t_phase:.1f} s in all, oracles, data and the child included; launches {launches}; {smi}")
    return launches


# ---------------------------------------------------------------------------
# phase 20: pod-scale banks
# ---------------------------------------------------------------------------
POD_SEED = 20
POD_BANK = (256, 2, 256)  # slots a tenant shard (2 shards: 512 tenants), requests a tenant, tenants a wave
POD_SPILL = 32  # tenants admitted past the capacity: each spills the least recently used one
POD_SOLO = 32  # tenants of compute_many held against solo collections
POD_RECOVERED = 16  # spilled tenants held against solo collections after recover()
POD_RANK_TIMEOUT_S = 420


def _pod_collection(mt):
    c = IMAGENET_VAL[1]
    return mt.MetricCollection(
        {
            "top5": mt.Accuracy(num_classes=c, top_k=TOP_K),
            "confmat": mt.ConfusionMatrix(num_classes=c, class_sharding="mp"),
        }
    )


def _pod_values(coll) -> dict:
    """A solo collection's values without the cross-process sync (the ranks
    are a world; each solo tenant is local)."""
    return {k: m.compute_state(m._snapshot_state()) for k, m in coll.items()}


def _pod_rank(rank: int, port: int, out_path: str, root: str) -> None:
    """One rank of phase 20 (this script run with ``--pod-rank``): join the
    gloo world of four on ``cuda:0``, serve the pod bank and save the
    checks' results and timings."""
    import gc
    import importlib
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.ops import confusion_counts as cc
    from metrics_tpu_torch.ops import select_topk as st
    from metrics_tpu_torch.serving import DiskStore, MetricBank, RequestRouter
    from metrics_tpu_torch.serving import pod as _pod

    torch.cuda.set_device(0)
    # four ranks share the host's cores: torch's default (a thread a core
    # in every rank) oversubscribes them on every host-side copy
    torch.set_num_threads(max(1, (os.cpu_count() or SHARD_WORLD) // SHARD_WORLD))
    _record_refusals()
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=SHARD_WORLD, rank=rank, timeout=timedelta(seconds=300)
    )
    cap, per, wave_size = POD_BANK
    n_main = 2 * cap
    c = IMAGENET_VAL[1]
    rec: dict = {"rank": rank}
    t_phase = time.perf_counter()
    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("host", "mp"))
    logits_np, target_np = _imagenet_stream(np.random.default_rng(POD_SEED), (n_main * per + POD_SPILL) * SERVE_REQ)
    pred1_np = logits_np.argmax(1)
    logits, target = torch.from_numpy(logits_np), torch.from_numpy(target_np)

    def block(t: int, r: int) -> int:
        return r * n_main + t if t < n_main else n_main * per + (t - n_main)

    def request(t: int, r: int):
        b = block(t, r) * SERVE_REQ
        return logits[b:b + SERVE_REQ], target[b:b + SERVE_REQ]

    # both kernels at the phase's shapes against their plain versions
    mp_idx = mesh.get_local_rank("mp")
    r0, rows = mp_idx * (c // 2), c // 2
    x, y = (v.cuda() for v in request(0, 0))
    p1 = x.argmax(1)
    _max_abs_err(torch, "phase 20 select_topk [64, 1000]", st._topk_mask_cuda(x, TOP_K), st._topk_mask_plain(x, TOP_K))
    _max_abs_err(
        torch, f"phase 20 confusion_counts window ({r0}, {rows})", cc._confusion_counts_cuda(p1, y, c, rows=(r0, rows)),
        cc._confusion_counts_plain(p1, y, c, rows=(r0, rows)),
    )
    seconds: dict = {}
    for key, module, name in _CHILD_TIMED:
        _time_into(seconds, key, importlib.import_module(module), name)
    for name in ("put", "get", "append_journal_many", "rewrite_journal"):
        _time_into(seconds, "io", DiskStore, name)
    _time_into(seconds, "exchange", _pod.PodLayout, "exchange")
    # where a wave's host time goes
    _time_into(seconds, "agree", _pod.PodLayout, "agree")
    for name in ("_prepare", "_admit_many", "_stack", "_run", "_write_back"):
        _time_into(seconds, name.strip("_"), MetricBank, name)

    baseline = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bank = MetricBank(
        _pod_collection(mt), capacity=cap, mesh=mesh, tenant_axis="host", name="smoke20", spill_store=DiskStore(root)
    )
    router = RequestRouter(bank, max_requests=wave_size, max_delay_s=None)
    waves = [(r, list(range(s, s + wave_size))) for r in range(per) for s in range(0, n_main, wave_size)]
    waves.append((0, list(range(n_main, n_main + POD_SPILL))))
    owned = 0
    wall, host_ms, syncs, dev_rows = [], [], [], None
    t0 = _reset_stats(torch, mt)
    for i, (r, group) in enumerate(waves):

        def submit(r=r, group=group):
            for t in group:
                router.submit(t, *request(t, r))
            router.flush()

        spill_wave = i == len(waves) - 1
        before = dict(seconds)
        torch.cuda.synchronize()
        t_w = time.perf_counter()
        if i == 0:
            submit()
        elif i == len(waves) - 2:  # the last full wave under the profiler: its device time
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                syncs.append(_host_syncs(torch, submit))
                torch.cuda.synchronize()
            dev_rows = _device_rows(prof)
        else:
            syncs.append(_host_syncs(torch, submit))
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t_w) * 1e3)
        host_ms.append(bank._last_flush_ms)
        owned += sum(bank._owns(bank._slots[t]) for t in group)
        split = {k: round((seconds.get(k, 0.0) - before.get(k, 0.0)) * 1e3, 1) for k in seconds}
        rec.setdefault("wave_split_ms", []).append({k: v for k, v in split.items() if v})
        if spill_wave:
            rec["spill_s"] = {k: seconds.get(k, 0.0) - before.get(k, 0.0) for k in seconds}
    graphs = sum(1 for p in bank._resident.programs.values() if not isinstance(p, (bool, str)))
    per_kernel = owned + graphs  # each capture's warm-up runs one request
    rec["seconds"], stats = _read_stats(torch, mt, t0, {"select_topk": per_kernel, "confusion_counts": per_kernel})
    rec["launches"] = _launches(stats)
    rec["owned"], rec["graphs"] = owned, graphs
    if any(syncs[:-1]):
        raise AssertionError(f"phase 20 rank {rank}: host syncs per replayed wave {syncs}")
    rec["wall_ms"], rec["host_ms"], rec["syncs"] = wall, host_ms, syncs
    rec["device_ms"] = sum(row["device_us"] for row in dev_rows) / 1e3 if dev_rows else None
    rec["device_ops"] = sum(row["calls"] for row in dev_rows) if dev_rows else None
    if bank.stats["spills"] != POD_SPILL or bank.stats["requests"] != n_main * per + POD_SPILL:
        raise AssertionError(f"phase 20 rank {rank}: bank stats {bank.stats}")

    # this rank's own rows against the numpy oracle, read locally (no exchange)
    local = bank._bank["confmat::confmat"].cpu().numpy()
    want = np.zeros((rows, c), np.int64)
    checked = 0
    for t, slot in bank._slots.items():
        if not bank._owns(slot):
            continue
        want[:] = 0
        picks = np.concatenate(
            [np.arange(block(t, r) * SERVE_REQ, (block(t, r) + 1) * SERVE_REQ) for r in range(bank.update_count(t))]
        )
        tg, pr = target_np[picks], pred1_np[picks]
        mine = (tg >= r0) & (tg < r0 + rows)
        np.add.at(want, (tg[mine] - r0, pr[mine]), 1)
        if not np.array_equal(local[bank._local_row(slot)], want):
            raise AssertionError(f"phase 20 rank {rank} tenant {t}: its rows {r0}..{r0 + rows - 1} differ from the oracle")
        checked += 1
    rec["rows_checked"] = checked
    del local

    # solo collections of the checked tenants, each fed its requests
    resident = list(range(POD_SPILL, POD_SPILL + POD_SOLO))
    recovered = list(range(POD_RECOVERED))
    solos = {}
    for t in resident + recovered:
        solo = _pod_collection(mt)
        for r in range(per):
            solo.update(*(v.cuda() for v in request(t, r)))
        solos[t] = _pod_values(solo)
        del solo

    def same_as_solo(name: str, values: dict) -> None:
        for t, got in values.items():
            for key, v in got.items():
                if not torch_equal(v, solos[t][key]):
                    raise AssertionError(f"phase 20 rank {rank} {name} tenant {t} {key}: differs from a solo collection")

    gathers = bank.stats["coalesced_gathers"]
    before = dict(seconds)
    torch.cuda.synchronize()
    t_c = time.perf_counter()
    values = bank.compute_many(resident)
    torch.cuda.synchronize()
    rec["compute_many_s"] = time.perf_counter() - t_c
    rec["exchange_s"] = seconds.get("exchange", 0.0) - before.get("exchange", 0.0)
    if bank.stats["coalesced_gathers"] != gathers + 1:
        raise AssertionError(f"phase 20 rank {rank}: compute_many took {bank.stats['coalesced_gathers'] - gathers} gathers")
    same_as_solo("compute_many", values)
    summary = bank.summary()
    summary.pop("flush_ms_ewma")
    rec["summary"] = summary
    rec["peak_gb"] = (torch.cuda.max_memory_allocated() - baseline) / 1e9
    rec["bank_gb"] = sum(v.numel() * v.element_size() for v in bank._resident.values()) / 1e9
    pool_id = bank._resident.pool
    rec["pool"] = _graph_pool_bytes(torch, pool_id)
    del bank, router, values
    gc.collect()
    torch.cuda.empty_cache()
    rec["pool_left"] = _graph_pool_bytes(torch, pool_id)
    if rec["pool_left"]:
        raise AssertionError(f"phase 20 rank {rank}: after del bank its graph pool holds {_mib(rec['pool_left'])}")

    # the kill: only the DiskStore survives; every rank recovers it into a fresh pod bank
    dist.barrier()
    torch.cuda.synchronize()
    t_r = time.perf_counter()
    back = MetricBank.recover(
        _pod_collection(mt), cap, DiskStore(root), name="smoke20", mesh=mesh, tenant_axis="host"
    )
    rec["recover_s"] = time.perf_counter() - t_r
    t_r = time.perf_counter()
    values = back.compute_many(recovered)
    torch.cuda.synchronize()
    rec["recovered_compute_s"] = time.perf_counter() - t_r
    if sorted(back.spilled_tenants) != list(range(n_main + POD_SPILL)) or any(back.update_count(t) != per for t in recovered):
        raise AssertionError(f"phase 20 rank {rank}: recovered {len(back.spilled_tenants)} sessions")
    same_as_solo("recovered", values)
    rec["disk_mb"] = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs) / 1e6
    rec["phase_s"] = time.perf_counter() - t_phase
    del back, values
    torch.save(rec, out_path)
    dist.destroy_process_group()


def run_pod_phase(torch, mt, smi: str) -> dict:
    """Phase 20: pod-scale banks on four gloo ranks. Returns the launches,
    credited per rank: the windowed confusion counts under
    ``confusion_counts@window``."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        ranks = _run_shard_ranks(
            out_dir, flag="--pod-rank", phase="20", timeout_s=POD_RANK_TIMEOUT_S, extra=(os.path.join(out_dir, "store"),)
        )
    first = ranks[0]["summary"]
    for rec in ranks[1:]:
        if rec["summary"] != first:
            raise AssertionError(f"phase 20: rank {rec['rank']}'s summary() differs from rank 0's: {rec['summary']} vs {first}")
    cap, per, wave_size = POD_BANK
    for rec in ranks:
        spill = rec["spill_s"]
        per_spill = {k: round(spill.get(k, 0.0) * 1e3 / POD_SPILL, 1) for k in ("exchange", "digest", "encode", "io")}
        dev = "not measured" if rec["device_ms"] is None else f"{rec['device_ms']:.2f} ms device, {rec['device_ops']} device operations"
        _log(
            f"phase 20 rank {rec['rank']}: MetricBank(capacity={cap}, mesh=(host=2, mp=2), tenant_axis='host') of top-5"
            f" Accuracy + ConfusionMatrix({IMAGENET_VAL[1]}, class_sharding='mp'), {2 * cap} tenants x {per} requests of"
            f" [{SERVE_REQ}, {IMAGENET_VAL[1]}] in {len(rec['wall_ms']) - 1} waves of {wave_size}, then {POD_SPILL} past"
            f" the capacity ({POD_SPILL} spills over the DiskStore): {rec['owned']} requests owned, launches"
            f" {rec['launches']} ({rec['graphs']} captures), {rec['rows_checked']} tenants' rows equal the oracle,"
            f" {POD_SOLO} tenants of compute_many and {POD_RECOVERED} recovered ones equal solo collections bit for bit;"
            f" ms per wave wall {[round(w, 1) for w in rec['wall_ms']]} (wave 1: the warm-up and capture; wave"
            f" {len(rec['wall_ms']) - 1} under the profiler; the last: the spill wave), host (apply_batch)"
            f" {[round(h, 1) for h in rec['host_ms']]}, split by wave {rec['wave_split_ms']} ms; {dev} (the profiled wave);"
            f" host syncs per wave {rec['syncs']};"
            f" {wave_size / (rec['wall_ms'][2] / 1e3):.0f} logical requests/s (wave 3; four ranks share the card);"
            f" compute_many of {POD_SOLO} {rec['compute_many_s'] * 1e3:.0f} ms, its read exchange"
            f" {rec['exchange_s'] * 1e3:.0f} ms; a spill {per_spill} ms (exchange, digest, encode, I/O; rank 0 alone"
            f" encodes and writes); recover() {rec['recover_s']:.2f} s, then {POD_RECOVERED} tenants decoded and computed"
            f" in {rec['recovered_compute_s']:.2f} s; peak {rec['peak_gb']:.2f} GB over the bank's {rec['bank_gb']:.2f} GB,"
            f" graph pool {_mib(rec['pool'])}, released on del bank; {rec['disk_mb']:.0f} MB on disk;"
            f" rank phase {rec['phase_s']:.1f} s"
        )
    _log(f"phase 20 summary() equal on every rank: {first}")
    launches = {
        "select_topk": sum(rec["launches"].get("select_topk", 0) for rec in ranks),
        "confusion_counts@window": sum(rec["launches"].get("confusion_counts", 0) for rec in ranks),
    }
    _log(f"phase 20 pod banks: {time.perf_counter() - t_phase:.1f} s in all; launches {launches}; {smi}")
    return launches


# ---------------------------------------------------------------------------
# phase 21: warm starts and drive snapshots
# ---------------------------------------------------------------------------
WARM_SEED = 21
WARM_BANK = (256, 256)  # 21a's bank: tenants (its capacity), requests a wave (19a's wave of [64, 1000] requests)
WARM_CHILD_TIMEOUT_S = 300
WARM_NEW_ROWS = 4096  # the batch of 21a's stale check: a shape the manifest never saw
SNAP_CHUNK = 2  # 21b: steps a chunk program replays, and the snapshot cadence in steps
SNAP_KILL_STEP = 4  # 21b: the child is killed once this step's snapshot is on disk


def _warm_stream():
    return _imagenet_stream(np.random.default_rng(WARM_SEED))


def _graphs(engine) -> int:
    return engine.cache_summary()["graphs"]


def _timed_first(torch, engine, fn):
    """``(ms, CUDA graphs captured)`` of one call."""
    torch.cuda.synchronize()
    g0, t0 = _graphs(engine), time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, _graphs(engine) - g0


def _warm_traffic(mt, logits, target):
    """21a's traffic, the same in every child: the main path's collection
    through ``forward`` (two batches of 8192, then the 848-row tail twice)
    and its ``compute()`` twice, and a collection bank of 256 tenants fed two
    waves of 256 requests of [64, 1000]. Returns the collection, the bank
    and ``(entry, first call, second call)`` triples."""
    from metrics_tpu_torch.serving import MetricBank

    n = IMAGENET_VAL[0]
    tenants, wave = WARM_BANK
    mc = _imagenet_collection(mt)
    bank = MetricBank(_imagenet_collection(mt), capacity=tenants, name="smoke21")

    def requests(w):
        return [(t, (logits[s:s + SERVE_REQ], target[s:s + SERVE_REQ])) for t, s in ((t, (w * tenants + t) * SERVE_REQ) for t in range(wave))]

    calls = [
        (f"forward [{BATCH}, {IMAGENET_VAL[1]}]", lambda: mc(logits[:BATCH], target[:BATCH]), lambda: mc(logits[BATCH:2 * BATCH], target[BATCH:2 * BATCH])),
        (f"forward [{RAGGED}, {IMAGENET_VAL[1]}]", lambda: mc(logits[n - RAGGED:], target[n - RAGGED:]), lambda: mc(logits[n - RAGGED:], target[n - RAGGED:])),
        ("compute", mc.compute, mc.compute),
        (f"bank wave of {wave} x [{SERVE_REQ}, {IMAGENET_VAL[1]}]", lambda: bank.apply_batch(requests(0)), lambda: bank.apply_batch(requests(1))),
    ]
    return mc, bank, calls


def _bank_digest(torch, bank, tenants) -> dict:
    """Each tenant's results: the scores by value, the confusion matrix by its sha256."""
    import hashlib

    out = {}
    for t, vals in bank.compute_many(list(range(tenants))).items():
        out[t] = {k: (hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest() if v.ndim else float(v)) for k, v in vals.items()}
    return out


def _warm_child(role: str, root: str) -> None:
    """Phase 21's fresh processes (``--warm-child ROLE DIR``), each with the
    persistent kernel cache in ``DIR/kernels`` (``METRICS_TPU_COMPILE_CACHE``,
    set by the parent): ``record`` builds the kernel library, records a
    manifest of 21a's traffic and saves it; ``cold`` serves the same
    traffic without one; ``warm`` warms from it first; ``kill`` streams
    21b's epoch with snapshots and waits to be killed at step 6; ``resume``
    resumes that epoch from its last snapshot. Each writes a record into
    ``DIR/ROLE.pt``."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import metrics_tpu_torch as mt
    from metrics_tpu_torch import engine, obs
    from metrics_tpu_torch.ops import _build
    from metrics_tpu_torch.serving import DiskStore

    t_start = time.perf_counter()
    _build.library()
    rec = {"build_s": _build.last_build_seconds, "persist": engine.persistent_cache_stats()}
    logits_np, target_np = _warm_stream()
    logits, target = torch.from_numpy(logits_np).cuda(), torch.from_numpy(target_np).cuda()
    manifest = os.path.join(root, "manifest.json")
    mt.reset_kernel_stats()
    if role in ("record", "cold", "warm"):
        mc, bank, calls = _warm_traffic(mt, logits, target)
        if role == "record":
            engine.record_manifest(manifest)
        if role == "warm":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec["engine_warmup"] = engine.warmup(manifest)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rec["bank_warmup"] = bank.warmup(manifest)
            torch.cuda.synchronize()
            rec["warmup_s"] = (t1 - t0, time.perf_counter() - t1)
        rec["entries"] = {}
        for name, first, second in calls:
            ms, graphs = _timed_first(torch, engine, first)
            rec["entries"][name] = {"first_ms": ms, "captures": graphs, "steady_ms": _timed_first(torch, engine, second)[0]}
        rec["values"] = {k: v.cpu() for k, v in mc.compute().items()}
        rec["bank"] = _bank_digest(torch, bank, WARM_BANK[0])
        if role == "record":
            rec["manifest_doc"] = {(e["kind"], e["source"]): len(e["programs"]) for e in engine.manifest_dict()["entries"]}
            engine.save_manifest()
        rec["report"] = engine.warmup_report()
        if role == "warm":
            with obs.capture(kinds=("warmup_stale",)) as events:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    mc(logits[:WARM_NEW_ROWS], target[:WARM_NEW_ROWS])
                torch.cuda.synchronize()
            rec["stale_events"] = [dict(e.data) for e in events]
    elif role == "kill":
        store = DiskStore(os.path.join(root, "snap"))
        mc = _imagenet_collection(mt)

        def stream():
            for i, (s, e) in enumerate(_batches(IMAGENET_VAL[0])):
                if i == SNAP_KILL_STEP + SNAP_CHUNK:
                    with open(os.path.join(root, "kill.ack"), "w") as f:
                        f.write(str(i))
                    time.sleep(WARM_CHILD_TIMEOUT_S)
                yield logits[s:e], target[s:e]

        engine.drive(mc, stream(), steps_per_chunk=SNAP_CHUNK, snapshot_store=store, snapshot_every=SNAP_CHUNK)
        raise AssertionError("phase 21b: the killed child's drive ended")
    elif role == "resume":
        mc = _imagenet_collection(mt)
        stream = ((logits[s:e], target[s:e]) for s, e in _batches(IMAGENET_VAL[0]))
        torch.cuda.synchronize()
        g0, t0 = _graphs(engine), time.perf_counter()
        res = engine.drive(mc, stream, steps_per_chunk=SNAP_CHUNK, resume_from=DiskStore(os.path.join(root, "snap")))
        torch.cuda.synchronize()
        rec.update(resume_ms=(time.perf_counter() - t0) * 1e3, captures=_graphs(engine) - g0, steps=res.steps)
        rec["states"] = {k: {n: v.cpu() for n, v in m._snapshot_state().items()} for k, m in mc.items()}
        rec["values"] = {k: v.cpu() for k, v in mc.compute().items()}
        rec["counts"] = {k: m._update_count for k, m in mc.items()}
    stats = mt.kernel_stats()
    rec["launches"] = _launches(stats)
    rec["plain_calls"] = sum(r["plain_calls"] for r in stats.values())
    rec["seconds"] = time.perf_counter() - t_start
    torch.save(rec, os.path.join(root, f"{role}.pt"))


def _start_warm_child(role: str, root: str):
    env = dict(os.environ, METRICS_TPU_COMPILE_CACHE=os.path.join(root, "kernels"))
    env.pop("METRICS_TPU_WARMUP_MANIFEST", None)
    log = open(os.path.join(root, f"{role}.log"), "w+")
    cmd = [sys.executable, os.path.abspath(__file__), "--warm-child", role, root]
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env), log


def _finish_warm_child(torch, role: str, root: str, proc, log, want_rc: int = 0) -> dict:
    t0 = time.monotonic()
    try:
        proc.wait(timeout=WARM_CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    log.seek(0)
    text = log.read()
    log.close()
    if proc.returncode != want_rc:
        raise AssertionError(f"phase 21 child {role}: {_exit_note(proc.returncode)} after {time.monotonic() - t0:.0f} s\n{text[-6000:]}")
    if want_rc:
        return {}
    rec = torch.load(os.path.join(root, f"{role}.pt"), weights_only=False)
    if rec["plain_calls"]:
        raise AssertionError(f"phase 21 child {role}: {rec['plain_calls']} plain calls on the card")
    return rec


def _run_warm_child(torch, role: str, root: str) -> dict:
    proc, log = _start_warm_child(role, root)
    return _finish_warm_child(torch, role, root, proc, log)


def _check_warm_kernels(torch, logits, target) -> str:
    """Phase 21's shapes: select_topk and confusion_counts against their plain versions."""
    from metrics_tpu_torch.ops import confusion_counts as cc
    from metrics_tpu_torch.ops import select_topk as st

    c, n = IMAGENET_VAL[1], IMAGENET_VAL[0]
    shapes = {"request": slice(0, SERVE_REQ), "batch": slice(0, BATCH), "tail": slice(n - RAGGED, n)}
    for label, rows in shapes.items():
        x, y = logits[rows], target[rows]
        _max_abs_err(torch, f"phase 21 select_topk {label}", st._topk_mask_cuda(x, TOP_K), st._topk_mask_plain(x, TOP_K))
        p1 = x.argmax(1)
        _max_abs_err(torch, f"phase 21 confusion_counts {label}", cc._confusion_counts_cuda(p1, y, c), cc._confusion_counts_plain(p1, y, c))
    return ", ".join(f"{k} [{s.stop - s.start}, {c}]" for k, s in shapes.items())


def run_warm_start_phase(torch, mt, smi: str, root: str) -> dict:
    """Phase 21a: record, cold and warm children. Returns their launches."""
    record = _run_warm_child(torch, "record", root)
    cold = _run_warm_child(torch, "cold", root)
    warm = _run_warm_child(torch, "warm", root)
    if record["persist"]["persistent_misses"] != 1 or record["build_s"] <= 0.0:
        raise AssertionError(f"phase 21a: the recording child did not build the kernel library: {record['persist']}")
    for name, rec in (("cold", cold), ("warm", warm)):
        if rec["persist"]["persistent_hits"] != 1 or rec["persist"]["persistent_misses"] or rec["build_s"] != 0.0:
            raise AssertionError(f"phase 21a {name}: no kernel-cache hit: {rec['persist']}, build {rec['build_s']} s")
    report = warm["report"]
    if report["programs_failed"] or report["stale_total"] or report["warmed_hits"] <= 0 or report["programs_warmed"] <= 0:
        raise AssertionError(f"phase 21a: the warm child's report {report}")
    if report["programs_warmed"] != report["manifest_programs"]:
        raise AssertionError(f"phase 21a: {report['programs_warmed']} of {report['manifest_programs']} programs warmed: {report}")
    ratios = {}
    for name, got in warm["entries"].items():
        want = cold["entries"][name]
        if got["captures"] != 0 or want["captures"] < 1:
            raise AssertionError(f"phase 21a {name}: {got['captures']} captures warm, {want['captures']} cold")
        ratios[name] = want["first_ms"] / got["first_ms"]
        if got["first_ms"] >= want["first_ms"]:
            raise AssertionError(f"phase 21a {name}: the warmed first request took {got['first_ms']:.2f} ms, the cold one {want['first_ms']:.2f} ms")
    for key, want in cold["values"].items():
        if not torch.equal(warm["values"][key], want) or not torch.equal(record["values"][key], want):
            raise AssertionError(f"phase 21a {key}: the warm, cold and recording children's values differ")
    if warm["bank"] != cold["bank"] or record["bank"] != cold["bank"]:
        raise AssertionError("phase 21a: the bank's tenants differ between the children")
    stale = warm["stale_events"]
    if len(stale) != 1 or "avals" not in stale[0]["explain"]["changed"]:
        raise AssertionError(f"phase 21a: the stale request's events {stale}")
    entries = "; ".join(
        f"{name}: cold {cold['entries'][name]['first_ms']:.1f} ms first ({cold['entries'][name]['captures']} captures),"
        f" warm {w['first_ms']:.1f} ms first (0 captures), x{ratios[name]:.2f}; steady {cold['entries'][name]['steady_ms']:.2f}"
        f" / {w['steady_ms']:.2f} ms"
        for name, w in warm["entries"].items()
    )
    _log(
        f"phase 21a warm start: the recording child built the kernel library in {record['build_s']:.1f} s"
        f" (persistent_misses 1) and recorded {record['manifest_doc']}; the cold and warm children loaded it"
        f" (persistent_hits 1, build 0.0 s); engine.warmup {warm['warmup_s'][0]:.2f} s, bank.warmup"
        f" {warm['warmup_s'][1]:.2f} s, {report['programs_warmed']} of {report['manifest_programs']} programs warmed,"
        f" skipped {report['skipped']}, {report['programs_failed']} failed, {report['warmed_hits']} warmed hits;"
        f" per entry (first request wall ms, captures, the cold/warm ratio; a second request's ms cold / warm): {entries};"
        f" values and all {WARM_BANK[0]} tenants bit for bit equal cold, warm and recorded; a [{WARM_NEW_ROWS},"
        f" {IMAGENET_VAL[1]}] batch raised warmup_stale naming {stale[0]['explain']['changed']}; children's seconds"
        f" {round(record['seconds'], 1)}, {round(cold['seconds'], 1)}, {round(warm['seconds'], 1)} (start and data included); {smi}"
    )
    launches: dict = {}
    for rec in (record, cold, warm):
        for op, n in rec["launches"].items():
            launches[op] = launches.get(op, 0) + n
    return launches


def run_snapshot_phase(torch, mt, smi: str, root: str, logits, target) -> dict:
    """Phase 21b: a child killed mid-epoch, a fresh child resumes; the
    uninterrupted drive and the snapshot costs here. Returns the launches
    of this process's drives and of the children."""
    from metrics_tpu_torch import engine
    from metrics_tpu_torch.engine import driver
    from metrics_tpu_torch.resilience import forge_snapshot_corruption
    from metrics_tpu_torch.serving import DiskStore, MemoryStore, durability_stats
    from metrics_tpu_torch.serving.store import reset_durability_stats
    from metrics_tpu_torch.utils.exceptions import StateIntegrityError

    def stream():
        return ((logits[s:e], target[s:e]) for s, e in _batches(IMAGENET_VAL[0]))

    proc, log = _start_warm_child("kill", root)
    snap_root = os.path.join(root, "snap")
    t0 = time.monotonic()
    while not os.path.exists(os.path.join(root, "kill.ack")):
        if proc.poll() is not None or time.monotonic() - t0 > WARM_CHILD_TIMEOUT_S:
            _finish_warm_child(torch, "kill", root, proc, log)  # raises with the child's log
        time.sleep(0.05)
    step = driver.load_drive_snapshot(DiskStore(snap_root)).step
    proc.kill()
    _finish_warm_child(torch, "kill", root, proc, log, want_rc=-9)
    if step != SNAP_KILL_STEP:
        raise AssertionError(f"phase 21b: the killed child's last snapshot is of step {step}, expected {SNAP_KILL_STEP}")
    resumed = _run_warm_child(torch, "resume", root)
    # the uninterrupted epoch with no program cached, as a fresh process has none
    engine.clear_cache()
    t0 = _reset_stats(torch, mt)
    plain = _imagenet_collection(mt)
    g0 = _graphs(engine)
    engine.drive(plain, stream(), steps_per_chunk=SNAP_CHUNK)
    torch.cuda.synchronize()
    plain_captures = _graphs(engine) - g0
    for key, m in plain.items():
        for name, v in m._snapshot_state().items():
            if not torch.equal(resumed["states"][key][name], v.cpu()):
                raise AssertionError(f"phase 21b: the resumed {key}.{name} differs from the uninterrupted drive's")
    for key, v in plain.compute().items():
        if not torch.equal(resumed["values"][key], v.cpu()):
            raise AssertionError(f"phase 21b: the resumed {key} value differs from the uninterrupted drive's")
    if resumed["counts"] != {k: m._update_count for k, m in plain.items()} or resumed["steps"] != len(_batches(IMAGENET_VAL[0])) - step:
        raise AssertionError(f"phase 21b: resumed counts {resumed['counts']}, {resumed['steps']} steps")
    if resumed["captures"] > plain_captures:
        raise AssertionError(f"phase 21b: the resume captured {resumed['captures']} programs, the uninterrupted drive {plain_captures}")
    # a forged snapshot: valid crcs, a failing digest
    forged = MemoryStore()
    forged.put("drive/drive", forge_snapshot_corruption(DiskStore(snap_root).get("drive/drive")))
    try:
        engine.drive(_imagenet_collection(mt), stream(), steps_per_chunk=SNAP_CHUNK, resume_from=forged)
    except StateIntegrityError as err:
        forged_note = str(err).splitlines()[0][:160]
    else:
        raise AssertionError("phase 21b: a forged snapshot resumed without an integrity error")
    # the drive's cost with and without snapshots (programs cached), and a boundary's split
    seconds: dict = {}
    originals = (driver._seal_snapshot, DiskStore.put)
    _time_into(seconds, "seal", driver, "_seal_snapshot")
    _time_into(seconds, "put", DiskStore, "put")
    timed = {False: [], True: []}
    try:
        for snap in (False, True, False, True):
            kw = {"snapshot_store": DiskStore(os.path.join(root, "timed")), "snapshot_every": SNAP_CHUNK} if snap else {}
            reset_durability_stats()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            engine.drive(_imagenet_collection(mt), stream(), steps_per_chunk=SNAP_CHUNK, **kw)
            torch.cuda.synchronize()
            timed[snap].append((time.perf_counter() - t1) * 1e3)
            if snap:
                written = durability_stats()
    finally:
        driver._seal_snapshot, DiskStore.put = originals
    drive_stats = mt.kernel_stats()
    n_snap = written["snapshots"]
    _log(
        f"phase 21b drive snapshots: ImageNet-1k val as a stream of {len(_batches(IMAGENET_VAL[0]))} batches, chunks of"
        f" {SNAP_CHUNK} steps, snapshot_every={SNAP_CHUNK} into a DiskStore; the child was killed (SIGKILL) with the"
        f" snapshot of step {step} on disk; a fresh child resumed in {resumed['resume_ms']:.1f} ms ({resumed['steps']}"
        f" steps, {resumed['captures']} captures, start and data not included; the uninterrupted drive here with no"
        f" program cached: {plain_captures} captures), states, counts and compute() bit for bit equal to the"
        f" uninterrupted drive's; a forged snapshot: StateIntegrityError ({forged_note}); drive ms without snapshots"
        f" {[round(x, 2) for x in timed[False]]}, with {[round(x, 2) for x in timed[True]]}"
        f" ({n_snap} snapshots a drive, {written['snapshot_bytes'] / max(n_snap, 1) / 1e6:.2f} MB each; seal"
        f" {seconds.get('seal', 0.0) * 1e3 / max(2 * n_snap, 1):.2f} ms and write {seconds.get('put', 0.0) * 1e3 / max(2 * n_snap, 1):.2f}"
        f" ms a boundary, on the host); {smi}"
    )
    launches = _launches(drive_stats)
    for op, n in resumed["launches"].items():
        launches[op] = launches.get(op, 0) + n
    return launches


def run_warm_snapshot_phase(torch, mt, smi: str) -> dict:
    """Phase 21: warm starts (21a) and drive snapshots (21b), in fresh
    child processes. Returns the launches of the phase."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    logits_np, target_np = _warm_stream()
    logits, target = torch.from_numpy(logits_np).cuda(), torch.from_numpy(target_np).cuda()
    shapes = _check_warm_kernels(torch, logits, target)
    with tempfile.TemporaryDirectory() as root:
        launches = run_warm_start_phase(torch, mt, smi, root)
        for op, n in run_snapshot_phase(torch, mt, smi, root, logits, target).items():
            launches[op] = launches.get(op, 0) + n
    _log(
        f"phase 21 warm starts and drive snapshots: {time.perf_counter() - t_phase:.1f} s in all; select_topk and"
        f" confusion_counts bit for bit against their plain versions at {shapes}; launches {launches}; {smi}"
    )
    return launches


# ---------------------------------------------------------------------------
# phase 22: the elastic fleet
# ---------------------------------------------------------------------------
FLEET_A = (4, 16, 48, 16)  # 22a: workers, capacity, tenants, the routers' max_requests
FLEET_ROUNDS = 4  # 22a: one request per tenant a round
FLEET_B = (4, 8, 4, 1, 3)  # 22b: workers, capacity, tenants a worker (a round is one wave of 4 on each), warm and measured rounds
FLEET_HEDGE_ROWS = 32  # 22b: rows of the requests left queued on the sick worker (a signature of their own)
FLEET_AUDIT = (4, 2, 8)  # 22b: the bitflip fleet's workers, tenants a worker (its waves), most rounds
FLEET_UPGRADE = (3, 2, 2)  # 22c: workers, tenants a worker, canary steps
FLEET_KV = (3, 2, 4)  # 22d: workers, tenants a worker, tenants owned by the joiner (each moves through the store)
FLEET_MEM_SLACK = 64 * 2**20  # 22a: what the card may still hold after the fleet is dropped


def _tenants_by_owner(fl, workers, per_worker: int, start: int) -> dict:
    """``{worker: [tenant ids]}``, the smallest integer ids from ``start``
    that rendezvous gives each worker, ``per_worker`` each."""
    epoch = fl.FleetEpoch(workers)
    out = {w: [] for w in epoch.workers}
    t = start
    while any(len(v) < per_worker for v in out.values()):
        w = fl.owner(t, epoch)
        if len(out[w]) < per_worker:
            out[w].append(t)
        t += 1
    return out


class _FleetRequests:
    """The phase's requests: block ``k`` of ``SERVE_REQ`` rows of phase 19's
    seeded ImageNet-1k-shaped stream, on the card, handed out in order; each
    tenant's blocks are kept so its solo twin is fed the same ones."""

    def __init__(self, torch, n_blocks: int):
        self.logits_np, self.target_np = _serving_stream(n_blocks * SERVE_REQ)
        self.logits = torch.from_numpy(self.logits_np).cuda()
        self.target = torch.from_numpy(self.target_np).cuda()
        self.next = 0
        self.n_blocks = n_blocks
        self.fed: dict = {}

    def take(self, tenant, rows: int = SERVE_REQ):
        if self.next >= self.n_blocks:
            raise AssertionError("phase 22: the request stream ran out")
        s = self.next * SERVE_REQ
        self.next += 1
        self.fed.setdefault(tenant, []).append((s, rows))
        return self.logits[s:s + rows], self.target[s:s + rows]

    def rows(self, tenant) -> np.ndarray:
        return np.concatenate([np.arange(s, s + n) for s, n in self.fed[tenant]])

    def feed(self, metric, tenant) -> None:
        for s, n in self.fed[tenant]:
            metric.update(self.logits[s:s + n], self.target[s:s + n])


class _FleetSplit:
    """Wall ms of the fleet's migration steps, summed while active: drain (a
    router's flush), export (the source's sealed payload, or the store read
    of a recovery), publish (the ledger), admit (decode and import). Wraps
    the fleet's own calls and puts them back on exit."""

    KEYS = ("drain", "export", "publish", "admit")

    def __init__(self, torch, fleet):
        from metrics_tpu_torch.fleet import migrate, router
        from metrics_tpu_torch.serving import store

        self.torch = torch
        self.ms = dict.fromkeys(self.KEYS, 0.0)
        self.counts = dict.fromkeys(self.KEYS, 0)
        self._sites = [
            (router.Worker, "drain", "drain"),
            (router.Worker, "export_payload", "export"),
            (store, "durable_tenant_payloads", "export"),
            (fleet.ledger, "publish", "publish"),
            (migrate, "admit_payload", "admit"),
        ]
        self._saved = []

    def _wrap(self, fn, key):
        torch = self.torch

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                self.ms[key] += (time.perf_counter() - t0) * 1e3
                self.counts[key] += 1

        return timed

    def __enter__(self):
        for owner, name, key in self._sites:
            own = name in vars(owner)  # a class's or a module's own; else a bound method of an instance
            self._saved.append((owner, name, vars(owner).get(name), own))
            setattr(owner, name, self._wrap(getattr(owner, name), key))
        return self

    def __exit__(self, *exc):
        for owner, name, fn, own in reversed(self._saved):
            if own:
                setattr(owner, name, fn)
            else:
                delattr(owner, name)
        self._saved.clear()

    def note(self) -> str:
        return ", ".join(f"{k} {self.ms[k]:.0f} ms ({self.counts[k]})" for k in self.KEYS)


def _bank_graphs(bank) -> int:
    return sum(1 for p in bank._resident.programs.values() if not isinstance(p, (bool, str)))


def _bank_bytes(bank) -> int:
    return sum(t.numel() * t.element_size() for t in bank._resident.values())


def _fleet_a_tenants(fl, n_workers: int, n_tenants: int) -> list:
    """22a's integer tenant ids: as many on each first worker, of which as
    many go to the joiner at the next epoch, so that every first worker's
    waves and the joiner's first wave, before and after the join, fall in
    one pow2 bucket of requests (the waves the warmup manifest records are
    the joiner's)."""
    per = n_tenants // n_workers
    first, grown = fl.FleetEpoch(range(n_workers)), fl.FleetEpoch(range(n_workers + 1))
    held = {w: [] for w in range(n_workers)}
    for joining, quota in ((True, per // n_workers), (False, per)):  # the joiner's share first, then the rest
        t = 0
        while any(len(ts) < quota for ts in held.values()):
            w = fl.owner(t, first)
            if len(held[w]) < quota and (fl.owner(t, grown) == n_workers) == joining and t not in held[w]:
                held[w].append(t)
            t += 1
    return sorted(t for ts in held.values() for t in ts)


def _check_fleet_values(torch, mt, name: str, values: dict, reqs: "_FleetRequests", make) -> None:
    """Every tenant's value, bit for bit, against a solo twin on the card fed
    the same requests in the same order, and its confusion matrix against
    numpy's ``bincount`` of its rows."""
    c = IMAGENET_VAL[1]
    for t, got in values.items():
        solo = make(mt)
        reqs.feed(solo, t)
        want = solo.compute()
        if not isinstance(want, dict):
            want, got = {"confmat": want}, {"confmat": got}
        for key, v in want.items():
            if not torch_equal(got[key].cpu(), v.cpu()):
                raise AssertionError(f"{name} tenant {t} {key}: differs from its solo twin")
        rows = reqs.rows(t)
        oracle = _confusion_oracle(reqs.logits_np[rows].argmax(1), reqs.target_np[rows], c)
        if not np.array_equal(got["confmat"].cpu().numpy(), oracle):
            raise AssertionError(f"{name} tenant {t}: the confusion matrix differs from np.bincount")


def _confmat_1000(mt):
    return mt.ConfusionMatrix(num_classes=IMAGENET_VAL[1])


def run_fleet_elastic(torch, mt, smi: str, reqs: "_FleetRequests", root: str) -> dict:
    """Phase 22a: workers join, are killed, die and leave under traffic;
    every tenant ends bit for bit as its solo twin. Returns the launches."""
    import gc
    import importlib

    from metrics_tpu_torch import engine
    from metrics_tpu_torch import fleet as fl
    from metrics_tpu_torch.resilience import FaultPlan
    from metrics_tpu_torch.serving import DiskStore, durability_stats

    n_workers, cap, n_tenants, max_req = FLEET_A
    tenants = _fleet_a_tenants(fl, n_workers, n_tenants)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # the join(5) of step 8 is the fleet's epoch 5: the plan fells worker 5 at its first admission
    plan = FaultPlan([{"kind": "kill", "rank": 5, "epoch": 5}])
    fleet = fl.Fleet(
        _imagenet_collection(mt), workers=list(range(n_workers)), capacity=cap, name="smoke22a", max_requests=max_req,
        max_delay_s=None, fault_plan=plan, durable_store=DiskStore(os.path.join(root, "store22a")),
    )
    split = _FleetSplit(torch, fleet)
    notes = []

    def submit(group) -> None:
        for t in group:
            fleet.submit(t, *reqs.take(t))

    def a_round(group=tenants) -> float:
        t0 = time.perf_counter()
        submit(group)
        fleet.flush()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def change(label, fn, old, planned=None):
        """One membership change: its ms split, moves and bytes; the rendezvous
        shape of its move map (or of the planned map, where the plan felled
        the destination); the bank it decommissions freed."""
        before_stats = dict(fleet.stats)
        split.ms, split.counts = dict.fromkeys(split.KEYS, 0.0), dict.fromkeys(split.KEYS, 0)
        held_by = {w: _bank_bytes(wk.bank) for w, wk in fleet._workers.items() if wk.bank is not None}
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with split:
            moves = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        gc.collect()
        torch.cuda.synchronize()
        freed = held - torch.cuda.memory_allocated()
        freed_need = sum(n for w, n in held_by.items() if w not in fleet.epoch.workers)
        if freed_need and freed < freed_need:
            raise AssertionError(f"phase 22a {label}: {freed / 2**20:.1f} MiB freed, the departed banks held {freed_need / 2**20:.1f} MiB")
        new = fleet.epoch
        checked = planned if planned is not None else new
        fl.assert_minimal_moves(fl.placement_diff(tenants, old, checked), old, checked, n_tenants=n_tenants)
        real = {t: m for t, m in moves.items() if m[0] != m[1]}
        fl.assert_minimal_moves(real, old, new, n_tenants=n_tenants)
        delta = {k: fleet.stats.get(k, 0) - before_stats.get(k, 0) for k in ("migrations", "rebalance_bytes", "recovered_tenants", "resubmitted_requests", "kills", "dies")}
        notes.append(
            f"{label} (v{old.version} -> v{new.version}, workers {list(new.workers)}): {ms:.0f} ms ({split.note()}),"
            f" {len(moves)} moves, {delta['rebalance_bytes'] / 1e6:.1f} MB; freed {freed / 2**20:.0f} MiB (the departed"
            f" banks' {freed_need / 2**20:.0f} MiB); {delta}"
        )
        return moves, ms, delta

    mt.reset_kernel_stats()
    # 1. round 1, recorded into a warmup manifest; each worker's first flush is cold
    warm_mod = importlib.import_module("metrics_tpu_torch.engine.warmup")
    engine.record_manifest()
    try:
        r1_s = a_round()
        doc = engine.manifest_dict()
    finally:
        warm_mod.stop_recording()
    cold_ms = [fleet.worker(w).bank._last_flush_ms for w in range(n_workers)]
    # 2. join(4), warmed from the manifest
    old = fleet.epoch
    moves, join_ms, _ = change("join(4, manifest=)", lambda: fleet.join(4, manifest=doc), old)
    if any(dst != 4 for _, dst in moves.values()) or fleet.stats.get("warmup_failures", 0):
        raise AssertionError(f"phase 22a join: moves {moves}, stats {fleet.stats}")
    joiner = fleet.worker(4)
    graphs = _bank_graphs(joiner.bank)
    # 3. round 2: the joiner's first flush replays what the warm captured
    r2_s = a_round()
    warm_ms = joiner.bank._last_flush_ms
    if _bank_graphs(joiner.bank) != graphs or graphs < 1:
        raise AssertionError(f"phase 22a: the warmed joiner captured at its first flush ({graphs} graphs warmed, {_bank_graphs(joiner.bank)} after)")
    # 4. kill(1) with its share of round 3 still queued
    queued = [t for t in tenants if fleet.owner_of(t) == 1]
    submit(queued)
    if fleet.worker(1).router.pending != len(queued):
        raise AssertionError(f"phase 22a: {fleet.worker(1).router.pending} queued on worker 1, {len(queued)} submitted")
    resub = fleet.stats["resubmitted_requests"]
    old = fleet.epoch
    moves, kill_ms, delta = change("kill(1)", lambda: fleet.kill(1), old)
    if fleet.stats["resubmitted_requests"] - resub != len(queued) or delta["recovered_tenants"] != len(moves):
        raise AssertionError(f"phase 22a kill: resubmitted {fleet.stats['resubmitted_requests'] - resub} of {len(queued)} queued; {delta}")
    # 5. the rest of round 3
    r3_s = a_round([t for t in tenants if t not in queued])
    # 6. die(2): the bank and router are gone before recovery; the store is all it reads
    shell = fleet.worker(2)
    owned = [t for t in tenants if fleet.owner_of(t) == 2]
    reads = durability_stats()["blob_reads"]
    old = fleet.epoch
    moves, die_ms, delta = change("die(2)", lambda: fleet.die(2), old)
    if shell.bank is not None or shell.router is not None or sorted(moves) != sorted(owned):
        raise AssertionError(f"phase 22a die: shell bank {shell.bank}, moves {sorted(moves)} vs owned {sorted(owned)}")
    if durability_stats()["blob_reads"] - reads < len(owned) or delta["dies"] != 1:
        raise AssertionError(f"phase 22a die: {durability_stats()['blob_reads'] - reads} blob reads for {len(owned)} tenants; {delta}")
    # 7. leave(0)
    old = fleet.epoch
    change("leave(0)", lambda: fleet.leave(0), old)
    # 8. round 4, with join(5) in the middle: the plan fells worker 5 at its first admission
    half = tenants[: n_tenants // 2]
    submit(half)
    old = fleet.epoch
    moves, _, delta = change("join(5), felled at admission", lambda: fleet.join(5), old, planned=old.join(5))
    if delta["kills"] != 1 or 5 in fleet.epoch.workers or any(dst == 5 for _, dst in moves.values()):
        raise AssertionError(f"phase 22a: the plan's kill of the joiner: {delta}, moves {moves}")
    r4_s = a_round(tenants[n_tenants // 2:])
    # 9. every tenant's value, then the fleet dropped
    t0 = time.perf_counter()
    values = {t: {k: v.cpu() for k, v in d.items()} for t, d in fleet.compute_all().items()}
    compute_ms = (time.perf_counter() - t0) * 1e3
    launches = _launches(mt.kernel_stats())
    if set(launches) != {"confusion_counts", "select_topk"} or any(r["plain_calls"] for r in mt.kernel_stats().values()):
        raise AssertionError(f"phase 22a: kernel stats {mt.kernel_stats()}")
    if set(values) != set(tenants) or fleet.ledger.pending() or fleet._in_flight or fleet._parked_requests:
        raise AssertionError(f"phase 22a: {len(values)} tenants computed, ledger {fleet.ledger.pending()}, parked {fleet._in_flight} {fleet._parked_requests}")
    peak = torch.cuda.max_memory_allocated() - start
    stats = dict(fleet.stats)
    del fleet, shell, joiner, split
    gc.collect()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - start
    if left > FLEET_MEM_SLACK:
        raise AssertionError(f"phase 22a: the card holds {left / 2**20:.1f} MiB more than at the phase's start after the fleet was dropped")
    _check_fleet_values(torch, mt, "phase 22a", values, reqs, _imagenet_collection)
    for note in notes:
        _log(f"phase 22a {note}")
    _log(
        f"phase 22a elastic fleet: workers 0-3 (capacity {cap}, routers' max_requests {max_req}, a shared DiskStore,"
        f" checkpoint_every_n_flushes=1) serving {n_tenants} tenants of the main path's collection (ConfusionMatrix"
        f"({IMAGENET_VAL[1]}), requests of [{SERVE_REQ}, {IMAGENET_VAL[1]}]) through 4 rounds, join(4), kill(1) with"
        f" {len(queued)} requests queued, die(2), leave(0) and join(5) felled at admission: every tenant equals its solo"
        f" collection bit for bit and np.bincount; rounds {r1_s:.2f} / {r2_s:.2f} / {r3_s:.2f} / {r4_s:.2f} s; the"
        f" joiner's first flush {warm_ms:.0f} ms warmed (0 captures) against {[round(m) for m in cold_ms]} ms cold (each"
        f" first worker's first flush, its capture included); join {join_ms:.0f} ms, kill recovery {kill_ms:.0f} ms, die"
        f" recovery {die_ms:.0f} ms; compute_all {compute_ms:.0f} ms; peak {peak / 2**20:.0f} MiB over the phase's start,"
        f" {left / 2**20:.1f} MiB left after del fleet; stats {stats}; launches {launches}; {smi}"
    )
    return launches


def _measure_healthy_flush(fleet, owned, rounds: int, submit) -> list:
    """The flush ms of every worker's wave over ``rounds`` rounds."""
    out = []
    for _ in range(rounds):
        for w, ts in owned.items():
            submit(ts)
            out.append(fleet.worker(w).bank._last_flush_ms)
    return out


def run_fleet_guard(torch, mt, smi: str, reqs: "_FleetRequests", root: str) -> dict:
    """Phase 22b: a slow worker walks to ejection while its queued requests'
    hedges are delivered exactly once; then a corrupting worker is ejected
    through its audits. Returns the launches of the fleets' traffic."""
    from metrics_tpu_torch import fleet as fl
    from metrics_tpu_torch.resilience import FaultPlan, FaultSpec, IntegrityAuditor, parse_plan
    from metrics_tpu_torch.serving import DiskStore

    n_workers, cap, per, warm_rounds, measured_rounds = FLEET_B
    # each worker's wave tenants, and two more of worker 3's for the requests
    # left queued (a tenant's new request would flush its queued ones first)
    owned = _tenants_by_owner(fl, range(n_workers), per + 2, start=1000)
    hedged = owned[3][per:]
    owned = {w: ts[:per] for w, ts in owned.items()}
    tenants = [t for ts in owned.values() for t in ts]
    # worker 3 carries a slow spec from the start (so its flush path has the
    # gray-fault seam); it matches no epoch until the healthy flush is measured
    plan = FaultPlan([FaultSpec(kind="slow", rank=3, epoch=10**9, seconds=0.001)])
    fleet = fl.Fleet(
        _imagenet_collection(mt), workers=list(range(n_workers)), capacity=cap, name="smoke22b", max_requests=per,
        max_delay_s=None, fault_plan=plan, durable_store=DiskStore(os.path.join(root, "store22b")),
    )
    launches = {}

    def count(fn):
        mt.reset_kernel_stats()
        out = fn()
        for op, n in _launches(mt.kernel_stats()).items():
            launches[op] = launches.get(op, 0) + n
        return out

    def submit(group, via=fleet):
        for t in group:
            via.submit(t, *reqs.take(t))

    count(lambda: [submit(ts) for _ in range(warm_rounds) for ts in owned.values()])
    healthy = count(lambda: _measure_healthy_flush(fleet, owned, measured_rounds, submit))
    median = float(np.median(healthy))
    plan.specs[:] = [FaultSpec(kind="slow", rank=3, seconds=4 * median / 1e3)]
    clock = [0.0]
    guard = fl.FleetGuard(fleet, name="smoke22b", latency_threshold_ms=2 * median, probation_after=2, eject_after=1, clock=lambda: clock[0])
    walk, edges = [], []
    listener = mt.obs.bus.subscribe(
        lambda e: edges.append((e.data["state_from"], e.data["state_to"], e.data["reasons"]))
        if e.kind == "guard" and e.data.get("worker") == "3" else None
    )
    try:
        def guarded_round():
            submit(tenants, via=guard)
            guard.poll()
            walk.append(dict(guard.worker_states()))

        count(guarded_round)
        count(guarded_round)
        if walk[-1].get(3) != "probation":
            raise AssertionError(f"phase 22b: worker 3 after two slow rounds: {walk}")
        # requests of their own signature, left queued on the sick worker; their hedges arm
        for t in hedged:
            guard.submit(t, *reqs.take(t, FLEET_HEDGE_ROWS))
        clock[0] += 1.0
        guard.poll()
        if guard.stats["hedges_armed"] != len(hedged):
            raise AssertionError(f"phase 22b: hedges armed {guard.stats}")
        count(guarded_round)  # worker 3's third slow flush: ejected; the hedges go to the new owners
        count(lambda: guard.drain())
        states = guard.worker_states()
        dedup = fleet.request_dedup.summary()
        gstats = dict(guard.stats)
    finally:
        mt.obs.bus.unsubscribe(listener)
        guard.close()
    if states.get(3) != "ejected" or any(states.get(w) != "healthy" for w in range(3)) or any(s.get(w, "healthy") != "healthy" for s in walk for w in range(3)):
        raise AssertionError(f"phase 22b: states {states}, walk {walk}")
    if [e[:2] for e in edges] != [("healthy", "probation"), ("probation", "ejected")]:
        raise AssertionError(f"phase 22b: worker 3's walk {edges}")
    if gstats["hedges_delivered"] != len(hedged) or dedup["duplicates_applied"] != 0 or dedup["duplicates_dropped"] != len(hedged):
        raise AssertionError(f"phase 22b: hedges {gstats}, dedup {dedup}")
    values = {t: {k: v.cpu() for k, v in d.items()} for t, d in fleet.compute_all().items()}
    stats = dict(fleet.stats)
    del fleet, guard
    _check_fleet_values(torch, mt, "phase 22b", values, reqs, _imagenet_collection)
    _log(
        f"phase 22b guard: 4 workers, {per} tenants each (waves of {per}); a healthy flush {median:.1f} ms median over"
        f" {len(healthy)} flushes ({min(healthy):.1f}-{max(healthy):.1f}; the guard's default latency_threshold_ms is 250),"
        f" latency_threshold_ms {2 * median:.1f}, worker 3 slowed by {4 * median:.0f} ms a flush: walk {walk}; worker 3"
        f" {edges}; the others healthy throughout; hedges {gstats['hedges_armed']} armed, {gstats['hedges_delivered']}"
        f" delivered, dedup {dedup}; every tenant bit for bit against its solo collection; fleet {stats}; {smi}"
    )

    # the integrity plane: a worker whose state a bitflip plan corrupts after each checkpoint
    n_workers, per, most = FLEET_AUDIT
    owned = _tenants_by_owner(fl, range(n_workers), per, start=2000)
    tenants = [t for ts in owned.values() for t in ts]
    plan = parse_plan('[{"kind": "bitflip", "rank": 1, "times": 8}]')
    fleet = fl.Fleet(
        _confmat_1000(mt), workers=list(range(n_workers)), capacity=per + 2, name="smoke22b-sdc", max_requests=per,
        max_delay_s=None, fault_plan=plan, durable_store=DiskStore(os.path.join(root, "store22b-sdc")), audit_rate=1.0,
    )
    guard = fl.FleetGuard(fleet, name="smoke22b-sdc", probation_after=1, eject_after=2, min_workers=2, latency_threshold_ms=600_000.0)
    auditors = {w: IntegrityAuditor(fleet.worker(w).bank) for w in range(n_workers)}
    walk = []
    try:
        for step in range(most):
            count(lambda: submit(tenants, via=guard))
            for w, auditor in auditors.items():
                if w in fleet._workers and fleet.worker(w).bank is not None:
                    auditor.poll()
            walk.append(dict(guard.observe()))
            if walk[-1].get(1) == "ejected":
                break
        summary = guard.summary()
    finally:
        guard.close()
    del auditors
    if walk[-1].get(1) != "ejected" or any(walk[-1].get(w) != "healthy" for w in (0, 2, 3)) or summary["workers"]["1"]["audit_failures"] < 1:
        raise AssertionError(f"phase 22b bitflip: walk {walk}, summary {summary['workers']}")
    for t in tenants:
        bank = next(w.bank for w in fleet._workers.values() if w.bank is not None and (t in w.bank.tenants or t in w.bank.spilled_tenants))
        n = bank.update_count(t)
        solo = _confmat_1000(mt)
        for s, rows in reqs.fed[t][:n]:
            solo.update(reqs.logits[s:s + rows], reqs.target[s:s + rows])
        if not torch_equal(bank.tenant_state(t)["confmat"], solo.confmat):
            raise AssertionError(f"phase 22b bitflip: tenant {t} differs from its solo twin over its {n} acked requests")
    _log(
        f"phase 22b audits: 4 workers of ConfusionMatrix({IMAGENET_VAL[1]}), audit_rate=1, a bitflip plan on worker 1:"
        f" walk {walk}; worker 1 ejected after {summary['workers']['1']['audit_failures']} failed audits, its tenants"
        f" recovered bit for bit against their solo twins over the acked requests; fleet {dict(fleet.stats)}; {smi}"
    )
    del fleet
    return launches


def run_fleet_upgrade(torch, mt, smi: str, reqs: "_FleetRequests", root: str) -> dict:
    """Phase 22c: a clean rolling upgrade, then one whose canary corrupts its
    state and is rolled back; no acked request is lost. Returns launches."""
    from metrics_tpu_torch import fleet as fl
    from metrics_tpu_torch.resilience import parse_plan
    from metrics_tpu_torch.serving import DiskStore

    n_workers, per, canary_steps = FLEET_UPGRADE
    tenants = [t for ts in _tenants_by_owner(fl, range(n_workers), per, start=3000).values() for t in ts]
    fleet = fl.Fleet(
        _confmat_1000(mt), workers=list(range(n_workers)), capacity=per + 3, name="smoke22c", max_delay_s=None,
        durable_store=DiskStore(os.path.join(root, "store22c")), fault_plan=parse_plan("[]"),
    )
    mt.reset_kernel_stats()

    def pump(f):
        for t in tenants:
            f.submit(t, *reqs.take(t))
        f.flush()

    pump(fleet)
    reports, seconds = [], []
    bad = parse_plan('[{"kind": "bitflip", "rank": 0, "times": 8}]')
    for label, factory in (("clean", lambda wid, f: f.build_worker(wid)), ("bitflip canary", lambda wid, f: f.build_worker(wid, fault_plan=bad))):
        guard = fl.FleetGuard(fleet, name=f"smoke22c-{label}", probation_after=1, eject_after=2, min_workers=2, latency_threshold_ms=600_000.0)
        t0 = time.perf_counter()
        try:
            reports.append(fleet.rolling_upgrade(factory, guard=guard, canary_steps=canary_steps, on_step=pump))
        finally:
            guard.close()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    clean, rolled = reports
    if clean["rolled_back"] or sorted(clean["upgraded"]) != list(range(n_workers)) or clean["audit"]["failed"]:
        raise AssertionError(f"phase 22c clean rollout: {clean}")
    if not rolled["rolled_back"] or "integrity" not in rolled["breach"] or rolled["upgraded"]:
        raise AssertionError(f"phase 22c canary: {rolled}")
    if sorted(fleet.epoch.workers) != list(range(n_workers)) or fleet.worker(0).bank.state_fault_injector is not None:
        raise AssertionError(f"phase 22c: after the rollback {fleet.epoch}")
    pump(fleet)
    launches = _launches(mt.kernel_stats())
    values = {t: v.cpu() for t, v in fleet.compute_all().items()}
    stats = dict(fleet.stats)
    del fleet
    _check_fleet_values(torch, mt, "phase 22c", values, reqs, _confmat_1000)
    _log(
        f"phase 22c rolling upgrade: {n_workers} workers of ConfusionMatrix({IMAGENET_VAL[1]}), {len(tenants)} tenants,"
        f" canary_steps={canary_steps}: clean rollout {seconds[0]:.1f} s (upgraded {clean['upgraded']}, audits"
        f" {clean['audit']}); the bitflip canary rolled back in {seconds[1]:.1f} s (breach {rolled['breach']}, audits"
        f" {rolled['audit']}); no acked request lost: every tenant bit for bit against its solo twin; fleet {stats}; {smi}"
    )
    return launches


def run_fleet_kv(torch, mt, smi: str, reqs: "_FleetRequests", root: str) -> dict:
    """Phase 22d: a resize whose payloads cross ``KVLedger`` over the default
    ``TCPStore`` of a world of one. Returns the launches."""
    import torch.distributed as dist

    from metrics_tpu_torch import fleet as fl
    from metrics_tpu_torch.serving import DiskStore

    n_workers, per, joiner_share = FLEET_KV
    owned = _tenants_by_owner(fl, range(n_workers), per, start=4000)
    moving = _tenants_by_owner(fl, range(n_workers + 1), joiner_share, start=4000)[n_workers]
    tenants = sorted({t for ts in owned.values() for t in ts} | set(moving))
    if dist.is_initialized():
        raise AssertionError("phase 22d: a torch.distributed group is already initialised")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
    try:
        fleet = fl.Fleet(
            _confmat_1000(mt), workers=list(range(n_workers)), capacity=len(tenants), name="smoke22d", max_delay_s=None,
            ledger=fl.KVLedger(), durable_store=DiskStore(os.path.join(root, "store22d")),
        )
        mt.reset_kernel_stats()
        for t in tenants:
            fleet.submit(t, *reqs.take(t))
        fleet.flush()
        split = _FleetSplit(torch, fleet)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with split:
            moves = fleet.join(n_workers)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if not set(moving) <= set(moves) or fleet.ledger.pending():
            raise AssertionError(f"phase 22d: moves {moves}, pending {fleet.ledger.pending()}")
        for t in tenants:
            fleet.submit(t, *reqs.take(t))
        fleet.flush()
        launches = _launches(mt.kernel_stats())
        values = {t: v.cpu() for t, v in fleet.compute_all().items()}
        moved_mb = fleet.stats["rebalance_bytes"] / 1e6
        del fleet
    finally:
        dist.destroy_process_group()
    _check_fleet_values(torch, mt, "phase 22d", values, reqs, _confmat_1000)
    _log(
        f"phase 22d KVLedger over the default TCPStore (gloo, world size 1): join({n_workers}) moved {len(moves)}"
        f" tenants of ConfusionMatrix({IMAGENET_VAL[1]}) ({moved_mb:.1f} MB) in {ms:.0f} ms, {ms / len(moves):.0f} ms a"
        f" move ({split.note()}); every tenant bit for bit against its solo twin; {smi}"
    )
    return launches


def run_fleet_phase(torch, mt, smi: str) -> dict:
    """Phase 22: the elastic fleet on the card (22a membership, 22b the
    guard, 22c a rolling upgrade, 22d the ledger over the TCPStore).
    Returns the launches of the fleets' traffic."""
    t_phase = time.perf_counter()
    mt.engine.clear_cache()
    torch.cuda.empty_cache()
    reqs = _FleetRequests(torch, 640)
    launches: dict = {}
    with tempfile.TemporaryDirectory() as root:
        for label, run in (("22a", run_fleet_elastic), ("22b", run_fleet_guard), ("22c", run_fleet_upgrade), ("22d", run_fleet_kv)):
            t0 = time.perf_counter()
            for op, n in run(torch, mt, smi, reqs, root).items():
                launches[op] = launches.get(op, 0) + n
            _log(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    del reqs
    torch.cuda.empty_cache()
    _log(f"phase 22 elastic fleet: {time.perf_counter() - t_phase:.1f} s in all, oracles and solo twins included; launches {launches}; {smi}")
    return launches


def check_windowed_kernels(torch, rng):
    """Phase 16c: the class windows of the confusion-count kernels at the
    phase's shapes, each against its plain version and the matching slice
    of the whole-matrix kernel, timed beside its bound, its plain version
    and ``torch.bincount`` of the window's fused index."""
    from metrics_tpu_torch.ops import confusion_counts as cc

    dev = torch.device("cuda")
    n21k, c, steps = IMAGENET21K_VAL
    n = n21k // steps
    r0 = rows = c // 2
    preds = torch.from_numpy(rng.integers(0, c, n).astype(np.int32)).to(dev)
    target = torch.from_numpy(rng.integers(0, c, n).astype(np.int32)).to(dev)
    records, calls = {}, {}
    win = cc._confusion_counts_cuda(preds, target, c, rows=(r0, rows))
    errs = [
        _max_abs_err(torch, "confusion_counts@window[plain]", win, cc._confusion_counts_plain(preds, target, c, rows=(r0, rows))),
        _max_abs_err(torch, "confusion_counts@window[slice]", win, cc._confusion_counts_cuda(preds, target, c)[r0:r0 + rows]),
    ]
    for w0, w in ((0, rows), (c - 1, 1), (c // 3, 0)):
        errs.append(_max_abs_err(
            torch, f"confusion_counts@window[{w0}, {w}]", cc._confusion_counts_cuda(preds, target, c, rows=(w0, w)),
            cc._confusion_counts_plain(preds, target, c, rows=(w0, w)),
        ))
    small = torch.from_numpy(rng.integers(0, 300, 100_000)).to(dev)
    errs.append(_max_abs_err(  # the shared route: a 60-row window of 300 classes fits shared memory
        torch, "confusion_counts@window[shared]", cc._confusion_counts_cuda(small, small.flip(0), 300, rows=(120, 60)),
        cc._confusion_counts_plain(small, small.flip(0), 300, rows=(120, 60)),
    ))
    mine = (target >= r0) & (target < r0 + rows)
    key = ((target.long() - r0) * c + preds.long())[mine]
    records["confusion_counts@window"] = dict(
        source="metrics_tpu_torch/csrc/confusion_counts.cu",
        replaces="metrics_tpu/ops/confusion_counts.py:44",
        max_abs_err=max(errs),
        ms=_cuda_ms(torch, lambda: cc._confusion_counts_cuda(preds, target, c, rows=(r0, rows))),
        plain_ms=_cuda_ms(torch, lambda: cc._confusion_counts_plain(preds, target, c, rows=(r0, rows))),
        library_ms=_cuda_ms(torch, lambda: torch.bincount(key, minlength=rows * c)),
        shape=f"N={n}, C={c}, rows=({r0}, {rows})",
    )
    records["confusion_counts@window"]["bound_ms"], records["confusion_counts@window"]["bound_by"] = _bound_ms(
        2 * n * 4 + rows * c * 8, 5 * n
    )
    calls["confusion_counts@window"] = lambda: cc._confusion_counts_cuda(preds, target, c, rows=(r0, rows))

    n_ml, c_ml, steps_ml = OPENIMAGES_VAL
    n = n_ml // steps_ml
    c0, w = -(-c_ml // 2), c_ml // 2  # mp rank 1's columns: (9979, 9978)
    mp = torch.from_numpy((rng.random((n, c_ml)) < 0.5).astype(np.int32)).to(dev)
    mt_ = torch.from_numpy((rng.random((n, c_ml)) < OPENIMAGES_POSITIVES / c_ml * 100).astype(np.int32)).to(dev)
    win = cc._multilabel_counts_cuda(mp, mt_, cols=(c0, w))
    errs = [
        _max_abs_err(torch, "multilabel_counts@window[plain]", win, cc._multilabel_counts_plain(mp, mt_, cols=(c0, w))),
        _max_abs_err(torch, "multilabel_counts@window[slice]", win, cc._multilabel_counts_cuda(mp, mt_)[c0:c0 + w]),
    ]
    for w0, ww in ((0, c_ml // 2 + 1), (4, 16), (c_ml - 1, 1)):
        errs.append(_max_abs_err(
            torch, f"multilabel_counts@window[{w0}, {ww}]", cc._multilabel_counts_cuda(mp, mt_, cols=(w0, ww)),
            cc._multilabel_counts_plain(mp, mt_, cols=(w0, ww)),
        ))
    # rows of 80 columns: a window at a 16-byte boundary takes the 16-byte loads
    narrow_p, narrow_t = mp[:, :80].contiguous(), mt_[:, :80].contiguous()
    errs.append(_max_abs_err(
        torch, "multilabel_counts@window[16, 32]", cc._multilabel_counts_cuda(narrow_p, narrow_t, cols=(16, 32)),
        cc._multilabel_counts_plain(narrow_p, narrow_t, cols=(16, 32)),
    ))
    cols = torch.arange(w, device=dev, dtype=torch.int32)
    ml_key = ((cols * 2 + mt_[:, c0:c0 + w]) * 2 + mp[:, c0:c0 + w]).reshape(-1)
    records["multilabel_counts@window"] = dict(
        source="metrics_tpu_torch/csrc/confusion_counts.cu",
        replaces="metrics_tpu/ops/confusion_counts.py:109",
        max_abs_err=max(errs),
        ms=_cuda_ms(torch, lambda: cc._multilabel_counts_cuda(mp, mt_, cols=(c0, w))),
        plain_ms=_cuda_ms(torch, lambda: cc._multilabel_counts_plain(mp, mt_, cols=(c0, w))),
        library_ms=_cuda_ms(torch, lambda: torch.bincount(ml_key, minlength=4 * w)),
        shape=f"N={n}, C={c_ml}, cols=({c0}, {w})",
    )
    records["multilabel_counts@window"]["bound_ms"], records["multilabel_counts@window"]["bound_by"] = _bound_ms(
        2 * n * w * 4 + w * 4 * 8, 3 * n * w
    )
    calls["multilabel_counts@window"] = lambda: cc._multilabel_counts_cuda(mp, mt_, cols=(c0, w))
    for name, rec in records.items():
        _log(
            f"kernel {name} ({rec['shape']}): bit-identical to plain and to the slice of the whole kernel;"
            f" ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f}"
            f" bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']})"
        )
    return records, calls


KERNEL_SYMBOLS = {
    "confusion_counts": ("confusion_shared_kernel", "confusion_counts_kernel"),
    "multilabel_counts": ("multilabel_counts_kernel",),
    "select_topk": ("topk_mask_regs_kernel", "topk_mask_kernel", "topk_mask_f64_kernel"),
    "binned_counts": ("binned_hist_kernel", "binned_finish_kernel", "rank_thresholds_kernel"),
    "binned_calibration": ("calibration_private_kernel", "binned_calibration_kernel"),
    "launch_floor": ("FillFunctor",),
    "pairwise_reduce": (
        "prep_kernel", "euclid_tf32_kernel", "fold_rows_kernel", "pairwise_rows_kernel",
        "cosine_nan_rows_kernel", "cosine_col_partials_kernel", "cosine_fold_kernel", "cosine_rows_kernel",
    ),
}
PROFILE_CALLS = 10
PROFILE_ATTEMPTS = 3
PROFILE_BATCHES = 3


def _device_rows(prof):
    """Device-side events (kernels, memcpy, memset) by name; the CPU ops that
    launched them are left out, since they carry the same time again."""
    rows = []
    for evt in prof.key_averages():
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us:
            rows.append({"name": evt.key, "calls": evt.count, "device_us": dev_us})
    return sorted(rows, key=lambda r: -r["device_us"])


def _profile_path(torch, label: str, steps, top: int) -> None:
    """Wall and device time, busy share, events and host syncs per batch of one path."""
    m = _measure_batches(torch, steps)
    if not m["rows"]:
        _log(f"profile {label}: batch {m['wall_ms']:.2f} ms on the host clock; device time not measured (no device events)")
        return
    _log(
        f"profile {label}: batch (mean of {len(steps)}) {m['wall_ms']:.2f} ms wall, {m['device_ms']:.3f} ms device,"
        f" busy share {m['busy_ms'] / m['wall_ms']:.3f}, {m['events']:.0f} device events, {m['syncs']} host syncs{_overlap_note(m)};"
        f" top device ops over the {len(steps)} batches:"
    )
    for r in m["rows"][:top]:
        _log(f"  {r['device_us']:10.1f} us  x{r['calls']:<4d} {r['name'][:100]}")


def profile_device_time(torch, kernel_calls, paths):
    """Each wrapper's device time and device operations per call, one
    profile per call (``op@label`` names a second shape of op ``op``), and
    the launch floor (``launch_floor``: a one-element ``fill_``); then,
    for each path, the device busy share, host syncs and top device ops of
    a few of its batches."""
    from torch.profiler import ProfilerActivity, profile

    # device time of the op's kernels, of every device event (a wrapper's fills too), and device events, per call
    kernel_us, all_us, ops = {}, {}, {}
    for label, call in kernel_calls.items():
        symbols = KERNEL_SYMBOLS[label.split("@")[0]]
        # the profiler now and then records none of a session's device events: profile again, up to three times
        for _ in range(PROFILE_ATTEMPTS):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(PROFILE_CALLS):
                    call()
                torch.cuda.synchronize()
            rows = _device_rows(prof)
            hits = [r for r in rows if any(sym in r["name"] for sym in symbols)]
            if hits:
                break
        # each kernel launches once per call; a dropped profiler event would not bias its mean
        kernel_us[label] = sum(r["device_us"] / r["calls"] for r in hits) if hits else None
        all_us[label] = sum(r["device_us"] / r["calls"] for r in rows) if rows else None
        ops[label] = sum(r["calls"] for r in rows) / max(r["calls"] for r in rows) if rows else None
    shown = {
        k: ("not measured" if v is None else f"{v:.2f} us kernel, {all_us[k]:.2f} us all {ops[k]:.0f} device ops")
        for k, v in kernel_us.items()
    }
    _log(f"profile: device time per wrapper call {shown}")
    floor = kernel_us.get("launch_floor")
    _log(f"profile: launch floor (a one-element fill_, the least device time of a kernel): {'not measured' if floor is None else f'{floor:.2f} us'}")
    for i, (label, steps) in enumerate(paths.items()):
        _profile_path(torch, label, steps, top=15 if i == 0 else 8)
    return kernel_us


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU.", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.ops import _build

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    _log(smi)
    _log(
        f"reduced (depth, for the time limit): 12a and 17a images a set from {CIFAR10_TEST[0]} to {GEN_IMAGES};"
        f" 13a, 13e and 17a segments from {WMT14_NEWSTEST} to {MT_SEGMENTS}; 13b utterances from {LIBRISPEECH_TEST_CLEAN}"
        f" to {ASR_UTTERANCES}; 13c summaries from {CNNDM_TEST} to {SUM_SUMMARIES}; 14c images from {COCO_VAL2017[0]} to {MAP_IMAGES}"
    )

    _build.library()
    _log(f"build: {_build.last_build_seconds:.1f} s (0.0 = reused) -> {_build._library_path().name}")
    for line in _build.last_build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            _log(f"  ptxas: {line.strip()}")

    rng = np.random.default_rng(SEED)
    records, calls = check_and_time_kernels(torch, rng)
    window_records, window_calls = check_windowed_kernels(torch, rng)
    records.update(window_records)
    calls.update(window_calls)
    binned_records, binned_calls = check_and_time_binned(torch, rng)
    records.update(binned_records)
    calls.update(binned_calls)
    embeddings = _dml_embeddings(rng)
    pairwise_records, pairwise_calls = check_and_time_pairwise(torch, rng, embeddings)
    records.update(pairwise_records)
    calls.update(pairwise_calls)
    main_stats, mc, logits, target, host_stream = run_main_path(torch, mt, rng)
    main_top5 = mc.compute()["top5"].clone()
    t_new = time.perf_counter()
    extension_launches = run_classification_extension(torch, mt, rng, logits, target, host_stream)
    extension_launches += run_ordinal_grading(torch, mt, rng)
    seg_launches, seg_calls, seg_record = run_segmentation(torch, mt, rng, smi)
    calls.update(seg_calls)
    records["confusion_counts@segmentation"] = seg_record
    run_passage_ranking(torch, mt, rng)
    torch.cuda.empty_cache()
    _log(f"phases 9a, 9b, 9c and 9e: {time.perf_counter() - t_new:.1f} s in all, oracles and data included")
    engine_launches = run_engine_phase(torch, mt, smi, logits, target, host_stream)
    run_copy_phase(torch, mt, rng, logits, target)
    sync_launches = run_sync_phase(torch, mt, smi)
    ml_stats, (ml_cm, ml_probs, ml_target) = run_multilabel(torch, mt, rng)
    coco_stats, (curves, coco_probs, coco_target) = run_coco_curves(torch, mt, rng)
    calibration, probs = run_imagenet_calibration(torch, mt, logits, target)
    ctr_stats, (aurocs, ctr_scores, ctr_labels) = run_ctr_auroc(torch, mt, rng)
    pairwise_launches, pairwise_paths = run_pairwise_path(torch, mt, rng, embeddings)
    (nyu, depth_preds, depth_target, nyu_batches), (cos, student, teacher, feat_batches) = run_regression_path(torch, mt, rng)
    # after the engine phase, whose captures must be its own: these phases share its collection's programs
    t_new = time.perf_counter()
    wrapper_launches = run_wrappers_phase(torch, mt, logits, target, host_stream)
    run_multioutput_phase(torch, mt)
    for op, n in run_checkpoint_phase(torch, mt, logits, target).items():
        wrapper_launches[op] += n
    run_image_phase(torch, mt, smi)
    _log(f"phases 11a-11d: {time.perf_counter() - t_new:.1f} s in all, oracles and data included")

    def steps(metric, preds, labels, bounds):
        return [lambda s=s, e=e: metric(preds[s:e], labels[s:e]) for s, e in bounds[:PROFILE_BATCHES]]

    floor = torch.zeros(1, device="cuda")
    kernel_us = profile_device_time(
        torch,
        {**calls, "launch_floor": lambda: floor.fill_(1.0)},
        {
            "imagenet main path": steps(mc, logits, target, _batches(IMAGENET_VAL[0])),
            "coco multilabel confusion": steps(ml_cm, ml_probs, ml_target, _batches(COCO_VAL[0])),
            "coco curves": steps(curves, coco_probs, coco_target, _batches(COCO_VAL[0])),
            "imagenet calibration (streaming)": steps(calibration["streaming"][0], probs, target, _batches(IMAGENET_VAL[0])),
            "ctr auroc (binned + exact)": steps(aurocs, ctr_scores, ctr_labels, [(s, s + CTR_EVAL[1]) for s in range(0, CTR_EVAL[0], CTR_EVAL[1])]),
            **{f"{label} (one call)": [lambda fn=fn, args=args: fn(*args)] for label, (fn, args) in pairwise_paths.items()},
            "nyu depth regression": steps(nyu, depth_preds, depth_target, nyu_batches),
            "feature cosine similarity": steps(cos, student, teacher, feat_batches),
        },
    )
    # after the kernels' profiles: these phases profile the network's batches themselves
    t_new = time.perf_counter()
    run_generative_phase(torch, mt, smi)
    run_lpips_phase(torch, mt, smi)
    _log(f"phases 12a-12b: {time.perf_counter() - t_new:.1f} s in all, oracles and data included")
    bert_pairs = run_text_phase(torch, mt, smi)
    run_audio_detection_phase(torch, mt, smi)
    obs_launches = run_observability_phase(torch, mt, smi, mc, logits, target)
    shard_launches = run_sharded_phase(torch, mt, smi)
    run_encoder_mesh_phase(torch, mt, smi, bert_pairs)
    resilience_launches = run_resilience_phase(torch, mt, smi)
    serving_launches = run_serving_phase(torch, mt, smi, logits, target, main_top5)
    pod_launches = run_pod_phase(torch, mt, smi)
    warm_launches = run_warm_snapshot_phase(torch, mt, smi)
    fleet_launches = run_fleet_phase(torch, mt, smi)

    # each kernel's launches on the paths that run it, each counted from 0 just before its run
    launches = {
        **{
            k: v["launches"] + sync_launches.get(k, 0) + engine_launches.get(k, 0) + wrapper_launches.get(k, 0)
            + obs_launches.get(k, 0) + shard_launches.get(k, 0) + resilience_launches.get(k, 0)
            + serving_launches.get(k, 0) + pod_launches.get(k, 0) + warm_launches.get(k, 0) + fleet_launches.get(k, 0)
            for k, v in main_stats.items()
        },
        "confusion_counts": main_stats["confusion_counts"]["launches"] + sync_launches.get("confusion_counts", 0)
        + engine_launches.get("confusion_counts", 0) + extension_launches + wrapper_launches["confusion_counts"]
        + obs_launches["confusion_counts"] + shard_launches.get("confusion_counts", 0)
        + resilience_launches["confusion_counts"] + serving_launches["confusion_counts"]
        + warm_launches["confusion_counts"] + fleet_launches["confusion_counts"],
        "confusion_counts@segmentation": seg_launches,
        "confusion_counts@window": shard_launches["confusion_counts@window"] + pod_launches["confusion_counts@window"],
        "multilabel_counts@window": shard_launches["multilabel_counts@window"],
        "multilabel_counts": ml_stats["multilabel_counts"]["launches"],
        "binned_counts": coco_stats["binned_counts"]["launches"] + ctr_stats["binned_counts"]["launches"],
        "binned_calibration": sum(stats["binned_calibration"]["launches"] for _, stats in calibration.values()),
        "pairwise_reduce": pairwise_launches,
    }
    # a second shape of an op (``op@label``) is a record of its own, with its own launches
    kernels = [
        {
            "name": name.split("@")[0],
            "shape": rec["shape"],
            "route": "cuda",
            "source": rec["source"],
            "replaces": rec["replaces"],
            "launches": launches[name],
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "device_us": kernel_us[name],
        }
        for name, rec in records.items()
    ]
    _log(smi)
    _log(json.dumps({"kernels": kernels}))
    _log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sync-rank"]:
        _sync_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--shard-rank"]:
        _shard_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--encoder-rank"]:
        _encoder_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--serving-child"]:
        _serving_child(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--pod-rank"]:
        _pod_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        sys.exit(0)
    if sys.argv[1:2] == ["--warm-child"]:
        _warm_child(sys.argv[2], sys.argv[3])
        sys.exit(0)
    if sys.argv[1:2] == ["--resilience-rank"]:
        _resilience_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        sys.exit(0)
    sys.exit(main())
