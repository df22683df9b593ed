#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``jama16_retina_tpu_torch``) on one
CUDA card: the quickest proof that the port still builds, serves and
trains.

    python3 chip_smoke.py [--seed 0] [--profile DIR]

Every phase builds its members' initial weights through a memo of
``models.init.init_flax_default`` (``memoize_init``): a (seed, layout)
drawn before is copied, and its first reuse is drawn afresh and held
bitwise against the copy.

Phases, any failure exits nonzero before the result line:

1. device   - a CUDA card is required; prints its name, count, power limit.
2. build    - compiles every kernel from ``ops/csrc`` (``nvcc -Xptxas -v``)
              and the host-side image codec (the host C compiler);
              prints how many of B2's single-pass clusters (8 and 16
              blocks, 299 px) the card holds at once.
3. kernels  - each kernel against its plain PyTorch version on the card,
              at the shapes its path gives it: B4 (serve preprocess) rows
              bitwise and sums exactly; B1 (colour jitter) bitwise at
              [32, 299, 299, 3] and [3, 37, 53, 3]; B2 (normalize + colour
              jitter) bitwise on its single-pass route (one cluster per
              image) at [32, 299, 299, 3], [3, 37, 53, 3], [1, 1, 1, 3] and
              [5, 17, 23, 3] and on its two-pass route at
              [1, 1536, 1536, 3], each shape's route asserted, and one
              single-pass call traced to be one device kernel; B3 (AdamW)
              bitwise for 3 steps over the full leaf sets of Inception-v3
              (196 leaves; with the 5-class head too), ResNet-50 (161) and
              EfficientNet-B4 (418),
              each call's launches counted: one per 400 leaves, so two
              for EfficientNet-B4.
4. serve    - k=2 random Inception-v3 members (299 px, aux head, random BN
              statistics) written as ``params.npz`` member dirs; a float32
              ``ServingEngine`` with ``serve.fused_preprocess=true`` answers
              requests of 1, 8 and 13 rendered fundus canvases. Launch
              counts are reset just before and read just after; B4 must
              have launched once per chunk. Probabilities must be finite
              in [0, 1] and match the same engine on the CPU to atol 1e-4
              (TF32 off). The bf16 preset's deviation from float32 is
              reported.
5. train    - ``trainer.fit_synthetic`` of ``eyepacs_binary`` (Inception-v3,
              299 px, aux head, bf16 compute, batch 32) on 64 rendered
              canvases held on the device for 8 steps in each step form
              from one seeded init: the preset (B1 + plain AdamW) and
              ``train.use_pallas_fused=true`` (B2 + B3). Launch counts are
              reset just before and read just after each run: B1 = steps,
              B2 = B3 = 0 in the preset run; B2 = B3 = steps, B1 = 0 in the
              fused run. Losses must be finite and the trained member's
              parameters must differ from the init. Then one train forward
              and backward (TF32 off, dropout 0) at batch 4 on the card
              against the CPU, from one init and one augment draw. In
              float32: loss within 1e-3, gradients within 8 % relative L2
              and cosine >= 0.995 over all leaves (the float32 train
              gradient is ill-conditioned; see tests/test_torch_train.py),
              the worst leaf's relative L2 reported. In float64 (float32
              heads): loss within 1e-6 and every leaf within 1e-6 relative
              L2, so a fault in one small leaf cannot hide. The augmented
              batch is made on both devices and compared (1e-6); the
              CPU's feeds both networks.
6. fit      - the train -> validate -> checkpoint -> resume -> evaluate
              path at full width (``eyepacs_binary``: Inception-v3, 299 px,
              batch 32, the preset step with B1). The port's writer makes
              raw TFRecord splits (train 64 / val 32 / test 32 images in
              4 / 2 / 2 shards) and the val split is read back, timed
              (MB/s, and the CRC-32C alone). Run A: ``trainer.fit`` for 8
              steps with evals at 4 and 8, its train stream prefetched at
              the default ``data.prefetch_batches=2``; B1 must launch 8 times (counts
              reset just before, read just after), the eval records must
              hold finite val AUCs in [0, 1], ``best/`` and ``latest/``
              must exist with the latest step 8, and the result must have
              the reference's keys. Run B: 4 steps into a fresh workdir,
              then ``train.resume=true`` to 8: B1 launched 4 times in each
              call, a ``resume`` record at 4, and the state saved
              at step 4 restored onto the card and flattened again must
              equal it bitwise. The largest loss difference between runs
              A and B at steps 5-8 is printed, not asserted (the schedules
              differ: run B's first call decays over 4 steps; cuDNN's
              backward is not deterministic either). Then
              ``evaluate_checkpoints`` of run A's best step on ``test``
              with thresholds from ``val``, float32 with TF32 off, on the
              card and on the CPU, each writing its ``save_probs`` CSV:
              the card's probabilities within 1e-4 of the CPU's, and the
              two reports' AUC and operating points equal up to what
              images that close together can change (``reports_gap``).
              Printed, not
              asserted: step time over the stream beside the in-memory
              step time, one val eval's time, one checkpoint save's time
              and bytes, the phase's wall time. Then the 5-class head on
              the same splits (``icdr5``: Inception-v3, label smoothing
              0.1, its preset step, which runs no kernel): 4 steps of
              ``trainer.fit`` with one eval (finite val AUC of P(grade >=
              2)), and ``evaluate_checkpoints`` on ``test`` with
              thresholds from ``val`` on the card and on the CPU: every
              ``save_probs`` column (``prob_referable``,
              ``prob_grade_0..4``) within 1e-4, and both reports with
              ``accuracy`` and ``quadratic_weighted_kappa``. Its files
              are deleted.
7. times    - kernel and plain-version device time (``torch.profiler``;
              a kernel's time is the mean of its traced events times its
              launches a call; every trace's events are counted, a short
              one taken again once, then kept with its count printed,
              and a kernel trace with under half its events fails
              the run; ``BELOW_BOUND`` printed beside a time under its
              bound, which would be a measurement fault) beside each
              kernel's bound, B3's library yardstick
              (``torch.optim.AdamW(fused=True)``); B2's routes in turns
              (two pass, cluster 8, cluster 16, cluster 16, cluster 8, two
              pass) beside ``images.to(torch.float32)``, a PyTorch kernel
              that moves the same bytes; request latency with the
              device's idle share, and per step form the train step time
              (median after warm-up), images/s, idle share and peak device
              memory; printed, not asserted. ``--profile DIR`` adds tables
              of device time by kernel for one request and one train step
              of each form, written into DIR. B3's times also over the
              ResNet-50 and EfficientNet-B4 leaf sets.
8. models   - for each of ``resnet50``, ``efficientnet_b4`` and ``icdr5``
              (Inception-v3 with the 5-class head): phase 4 with k=2
              random members (the scale of a residual branch's last BN
              drawn small; ResNet-50's and EfficientNet-B4's BN statistics
              calibrated on 16 rendered canvases), B4 once per chunk, the
              5-class rows summing to 1 within 1e-6, card vs CPU 1e-4
              on the 1- and 13-row requests (the 8-row one on the card
              alone, for the time limit); phase 5's
              ``fit_synthetic`` for 2 steps per form (the preset forms
              launch no kernel; fused: B2 = steps, B3 = steps x
              ceil(leaves / 400)), finite losses and every parameter leaf
              moved (but EfficientNet's ``project_bn`` biases, whose true
              gradient is 0) and peak memory per form (the request and
              step times of these presets left to phase 7's preset and
              item 12's benchmark, for the time limit); and the
              float64 card-vs-CPU forward and
              backward of phase 5 on the same augmented batch (dropout
              and stochastic depth 0): loss within 1e-6 and every leaf
              within 1e-6 relative L2 (a leaf whose CPU gradient is below
              1e-9 of the whole gradient's norm is held against that
              floor: its true gradient is 0).

9. knobs    - the trainer's run knobs at full width (``eyepacs_binary``,
              299 px, batch 32), after phase 6 and on its splits. The
              train stream in turns (6-step fits, steps 3-5's median
              ``window_sec`` and ``input_wait_sec``): unprefetched
              (``data.prefetch_batches=0``, ``data.readers=1``),
              prefetched from one reader process (2, 1, the default),
              prefetched from two (2, 2), then unprefetched again. bf16
              master weights: a fused step with ``train.dtype=bf16`` and
              one with float32 params from one init on one batch, losses
              within 0.05 and not equal, every master and moment still
              float32, B2 = B3 = one a step; step ms and peak memory of
              both. Accumulation:
              ``compute_grads`` of 8 images tiled 4 times (augment draws
              tiled too, dropout 0, float32, TF32 off) whole and in 2 and 4
              micro-batches: losses within 1e-4, gradients within 8 %
              relative L2 and cosine >= 0.995; accum 2 on 8 distinct
              images against its two halves' gradients at accum 1, halved
              and summed in order (cuDNN deterministic): loss and gradient
              within 1e-6 relative L2; then fused steps at
              ``accum_steps`` 1, 2 and 4, B2 and B3 once a step, step ms
              and peak memory. Saves and evals off the loop: fits of 8
              steps with ``train.async_save`` and with ``train.async_save``
              + ``train.eval_overlap``: the save stall and the eval pause
              after the eval at 4 printed beside the sync 928.7 and
              297.1 ms of the last measurement before these knobs
              (``PERF.md``), and every saved step re-scored on the val split
              from its checkpoint must equal its recorded val AUC. Warm
              start: a fresh state seeded from run A's ``best/`` equals the
              donor's best step at step 0, and a 2-step fit from it writes
              its ``warm_start`` record.
10. serve knobs - the serving knobs at full width on phase 4's k=2
              ``eyepacs_binary`` members (299 px, bf16 compute, B4 on every
              chunk; launch counts set to 0 just before the phase's path
              and read just after: B4 once a chunk, no train kernel). Per
              ``serve.dtype`` fp32, bf16 and int8: the members' resident
              device bytes (int8 under 0.55x bf16, bf16 under 0.55x fp32),
              max |score - fp32| over 64 canvases, and request latency at
              batch 8 and 64 (median and range of 10 after 2 warm). The
              fp32 engine against one ``nn.Module`` per member driven by
              the request path the engine had before these knobs: scores
              within 1e-6, and each form's median request latency at batch
              8 and 64 in 10 alternating pairs. The construction gate on
              a canary of 8 canvases pinned from the fp32 scores: bf16
              and int8 pass at the default
              ``serve.dtype_canary_max_dev`` 0.05 and raise
              ``DtypeRejected`` at 0; fp32 skips it. ``serve.member_parallel``
              (one vmap over the stacked members) against the members in
              turn: member probabilities within 1e-4 in float32 (TF32 off),
              and both forms' latency at batch 8 and 64. The micro-batcher
              over one bucket of 32: 200 requests of 1-8 rows from 4
              closed-loop client threads, every row equal to the engine's
              score of that canvas at the same bucket, p50 and p99 of
              request latency; then the same 200 as a burst with
              ``serve.shed_queue_depth=8`` and a 5 ms deadline: the
              requests shed, expired and served must add up, match the
              ``serve.shed.*`` counters, and both be nonzero. The quality
              monitor fed by B4's statistics over 64 canvases: one window,
              the statistics within 1e-9 of a float64 numpy pass, and
              their distance and the histograms' count differences from
              the host pass (``input_stat_values``, float32 sums) printed.
11. optimizers, recipe, ensemble - after phase 9, on the fit phase's
              splits. (a) ``eyepacs_binary`` (Inception-v3, 299 px, batch
              32, bf16 compute, B1) from one seeded init under each of
              ``train.optimizer`` sgdm, rmsprop, lamb and adamw with
              ``train.gradient_clip_norm=1.0``: 3 steps (counts set to 0
              just before, read just after: B1 once a step), finite
              losses, the median step (steps 2-3), the device launches of
              one traced step and of the update alone, and peak memory;
              then one update on the same float32 gradients and state on
              the card and on the CPU, every parameter and state leaf
              within 1e-6 relative L2 (1e-5 for lamb). (b) A 4-step
              ``lamb`` fit with ``train.lr_scale_ref_batch=8`` (evals at 2
              and 4, cuDNN deterministic): the logged effective learning
              rate must be 4x ``learning_rate``; rerun with its own
              ``metrics.jsonl`` as ``train.recipe_curve_ref`` it passes;
              against that curve shifted by -0.5 it stops at step 2 with
              ``RecipeCurveRejected``. (c) ``ensemble10`` stacked
              (``train.ensemble_parallel`` + ``_force``, B1, constant
              learning rate, cuDNN deterministic): B1 bitwise at the
              stacked shape [k x 32, 299, 299, 3]; a 4-step fit with
              evals every 2 at k = 2 (``ensemble10``'s ten members cut
              to two for the time limit; an out-of-memory error is
              printed with the free bytes): B1 once a stacked step, every ``member_NN/{best,
              latest}`` and ``run_meta`` seed, per-member and ensemble
              val AUCs; the same run cut at step 2 and resumed to 4 ends
              bitwise where the uninterrupted one did, member by member;
              one stacked step against the k members stepped in turn
              (float32, TF32 off, sgdm, batch 8): losses within 1e-3, each
              member's update within 8 % relative L2 and cosine >= 0.995
              (the float32 card-vs-CPU gradient bar of phase 5); and the
              stacked step timed against k member steps in turns
              (stacked, then in turn; bf16, batch 32, adamw):
              median ms, member images/s, peak memory and the ratio.
12. cascade  - after phase 11, on the fit phase's splits. (a) Two random
              ``eyepacs_binary`` members (``ensemble10``'s, cut from ten
              for the time limit) as the teacher: its float32 soft targets of 4 canvases on the card
              against the CPU within 1e-4 (TF32 off); a 4-step student fit
              with ``train.distill_from`` (bf16 masters, fused form, batch
              32, constant learning rate, evals every 2, cuDNN
              deterministic): its ``distill`` record, B2 = B3 = 4, and the
              same fit cut at step 2 and resumed bitwise the uninterrupted
              one. (b) The cascade of that student (its best step) and the
              two members (float32 compute, fused preprocess) over 64
              canvases, threshold at the median student score and a band
              escalating about 30 %: student rows bitwise
              ``student.probs``, escalated rows bitwise
              ``ensemble.probs(images[mask])``, counters equal the mask's;
              speculative against serial within 1e-6; cascade, speculative,
              ensemble and student requests at batch 8 and 64 (median and
              range of 3 after 2 warm). (c) ``assemble(go_live=True)`` of
              a band covering [0, 1] passes against a canary pinned from
              the ensemble's scores (and ``auc_floor`` on the 64 graded
              canvases); a student with head bias +20 at band 0 raises
              ``CascadeRejected``. (d) The ensemble engine under the
              micro-batcher (one bucket of 32, 4 closed-loop clients):
              ``reload`` to two other members and ``rollback`` mid-run,
              no request failing, every response's rows those of the
              generation ``probs_with_generation`` named (float32 bar
              1e-4), reload and rollback ms, ``memory_allocated`` before,
              with a generation retained and after ``release_retained``; a
              canary-failing candidate raises ``ReloadRejected``; a shadow
              at 0.25 samples every 4th request. Launch counts are set to
              0 before (b) and read after (d): B4 once a chunk.
13. router   - after phase 12, on phase 4's k=2 members and phase 12's
              student, two members and 64 canvases (``eyepacs_binary``,
              Inception-v3, 299 px, aux head, float32 compute, TF32 off,
              ``serve.fused_preprocess``, buckets 8, 16, 32, 64); launch
              counts set to 0 just before each part and read just after:
              B4 once a chunk (once a fused bin), no train kernel. (a) Two
              replicas of the k=2 engine under ``least_in_flight`` and
              ``bucket_affinity``, 1.5 s each of 3 interactive (1-8 rows)
              and 1 batch (64 rows) closed-loop clients: every response
              row bitwise its replica engine's score of that canvas at
              the bucket its bin ran at, segments naming replica and
              generation; p50/p99 per class and each replica thread's
              first bin against its steady bins; a routed batch-8
              request's idle share beside the engine's; a burst under
              ``serve.router_shed_rows`` sheds batch first; a replica
              raising from its 3rd bin on is marked failed and no request
              fails; a drain halfway through the load completes. (b) Two
              tenants (k=2 each, one fusion token, one bucket of 8, 4 rows
              each) with ``router_fusion``: one fused bin, one B4 launch,
              rows bitwise each tenant's direct rows with members in turn
              and within 1e-5 under ``serve.member_parallel``; fused vs
              grouped ms. (c) Two student ``CascadeEngine`` replicas over
              one ``EscalationPool`` of the two members: rows bitwise
              phase 12's serial and speculative cascades,
              ``serve.router.escalations`` = 2 x the mask's sum both ways,
              ``serve.router.speculations`` = the speculated rows. (d) A
              replica factory (``scaler_min_replicas`` 1, max 3, window
              0.5 s): a 3 s burst scales up, quiet drains; the ledger
              printed. (e) A frontier swept through the router (buckets 8,
              16, 32, 64 x concurrency 1, 4, 0.6 s each), ``derive_policy``
              -> ``save_policy`` -> ``load_policy`` ->
              ``maybe_apply_policy`` on a fresh config, and a router built
              from it; the derived knobs printed beside the card.
14. jpeg and host - after phase 13, with no OpenCV, PIL or TensorFlow.
              (a) Every fixture of ``tests/data/jpeg`` decoded on this
              machine's host, bitwise its ``manifest.json`` digests: the
              host path (EXIF applied) OpenCV's, the records path (EXIF
              ignored) TensorFlow's, the progressive ones among them; an
              arithmetic-coded JPEG (a baseline fixture with its frame
              marked SOF9) refused naming item 14. (b) JPEG TFRecord splits packed from the fixtures
              with ``make_jpeg_example`` (train 64 / val 32 / test 32 in 4
              / 2 / 2 shards; train the eight 299-px renders repeated with
              grades cycling, every fourth val and test record a 317-px
              render, resized to 299 on read): ``trainer.fit`` of
              ``eyepacs_binary`` (Inception-v3, 299 px, batch 32, preset
              step, default readers) for 8 steps with evals at 4 and 8, B1
              8 times (counts set to 0 just before, read just after), then
              phase 6's card-vs-CPU evaluation of its best step. (c)
              Printed, not asserted: records decoded a second by one
              process (JPEG and raw at 299 px, the 1024-px fixture with and
              without the resize), and the stream step from the JPEG
              splits against the same pixels written raw, in turns, at
              ``data.readers`` 1 (phase 9 drives 2 readers). (d) ``predict.main`` with
              ``serve.fused_preprocess=true`` (float32 compute) on the
              fixture photos, the EXIF-rotated one, the progressive one, a
              junk file and the arithmetic-coded JPEG against phase 4's k=2
              members: junk skipped as ``unreadable``, the arithmetic one
              naming item 14, ``serve.input_rejected.decode_error`` up
              by 2, the progressive photo kept, B4 once per chunk, the
              quality monitor on (a profile with input histograms) and
              ``serve.preprocess.fused_rows``
              the kept rows it read, the kept canvases bitwise the
              manifest's, rows within 1e-4 of the same engine on the
              CPU. (e) The host stage's wall time per batch of 1, 8 and
              64 photos at 299 and 1024 px, with one worker thread and
              the default.
15. obs     - telemetry, tracing, the flight recorder and alerts, on phase
              6's splits, each path's launch counts set to 0 just before it
              and read just after. (a) A 16-step ``eyepacs_binary`` fit
              (fused step, evals at 8 and 16) with the ``obs`` defaults,
              ``obs.flush_every_s`` small enough for 3 flushes or more,
              ``train.profile_steps=3`` and ``train.tensorboard=true``: B2
              and B3 16 times; the telemetry and heartbeat records counted,
              ``telemetry.prom`` parsed, the Chrome-trace events by name
              (the stall segments among them), the tfevents records, and
              the kernels of the ``torch.profiler`` window (B2 and B3
              among them). (b) The drills: a 24-step preset-form fit with
              ``obs.slow_step_factor=0.5`` writes exactly one blackbox
              (``slow_step``, with ``diagnosis.json``) and opens exactly
              one armed capture, whose kernels include B1; a fit in a
              child process sent SIGTERM mid-run leaves a ``sigterm``
              blackbox and a ``preempt_save`` record and exits 143. (c)
              ``python -m jama16_retina_tpu_torch.predict --obs_workdir``
              (in process, fused preprocess) over (a)'s member on the
              eight 299-px fixture photos, with the user rule
              ``serve.engine.rows > 0 -> slo_breach``: B4 once per chunk,
              its ``alert`` record and blackbox, the heartbeats and the
              final one. (d) A lone batch-8 request routed (phase 13a's
              settings, one replica) and to the engine alone, 10 each
              after 2 warm, with tracing on: the request's wall time split
              per thread and segment from the trace (the caller, the tick
              thread's ticks, the replica worker's engine spans). (e) The
              planes' cost: the fused step's window (steps 3-8 of 8-step
              fits, median and range) with ``obs.enabled=false`` and the
              default, one fit each, and the batch-8 request (10 calls a
              turn) with the registry and tracer off, on, on, off.
16. faults  - fault injection and bounded retries (``obs/faultinject.py``,
              ``utils/retry.py``) at full width, on phase 6's splits and
              phase 4's k=2 members, each path's launch counts set to 0
              just before it and read just after; after every drill no
              plan is armed and ``JAMA16_FAULTS`` is unset (the variable
              is set only in a child's own env). (a) ``tfrecord.read``
              OSError on call 3: ``train_batches`` at ``data.readers`` 1
              and 2 yields 8 batches bitwise the unarmed stream, and an
              8-step preset fit with the plan in ``obs.fault_plan`` ends
              with the trainer's ``io.retries.tfrecord.read`` equal to the
              readers' summed fires (1 at one reader; the ordinals count
              per reader), B1 8 times. (b) An 8-step fused fit (evals every
              4) under ``trainer.step`` RuntimeError on call 6 raises,
              leaves one ``exception`` blackbox, no ``preempt_save`` and an
              eval at 4 only (B2 = B3 = 5); its resume under
              ``ckpt.restore`` OSError on call 1 retries once
              (``io.retries.ckpt.restore`` 1), restores the step-4 tensors
              bitwise and runs to 8 (B2 = B3 = 4). (c) A child fit with
              ``train.async_save`` whose step-4 save is held by a
              ``ckpt.save`` latency plan is killed with SIGKILL: ``latest/``
              is whole at step 2 or 4 and a resume completes (B1 once a
              step). (d) ``engine.dispatch`` RuntimeError on call 2 under
              the micro-batcher (bf16, one bucket of 8, 12 requests of 8):
              only the second window fails, the worker survives, the rest
              are bitwise the unarmed engine's, B4 once a chunk. (e)
              ``serve.router.dispatch`` error on call 2 over two replicas
              (phase 13a's settings with one bucket of 8): one replica
              failed, ``serve.router.retried_bins`` >= 1, no request
              failed, every row bitwise its replica engine's. (f)
              ``host.decode`` OSError on call 2 through ``predict.main`` on
              the eight 299-px fixture photos, one host worker: with
              ``--max_retries 2`` 8 rows, one ``"retried": true``,
              ``serve.input_retried`` 1, rows and canvases bitwise the
              unarmed run's; with ``--max_retries 0 --strict`` 7 rows, one
              ``unreadable`` reject, exit 2. (g) ``integrity.write`` bitflip
              on phase 13e's serve-policy save: ``load_policy`` refuses it;
              a checksum refusal counts ``integrity.corrupt`` and fires
              ``artifact_corrupt`` at the next flush; the file is deleted.
              Each drill's plan counts and wall time are printed.
17. preprocess - the reference's preprocess runners on this machine's
              host, with no OpenCV, PIL or TensorFlow, then their records
              on the card; launch counts set to 0 just before each path
              and read just after. (a) ``encode_jpeg`` of every photo of
              ``tests/data/preprocess/manifest.json``'s ``encode`` list
              and of its 299-px canvas: the sha256 of ``cv2.imencode``'s
              bytes (quality 92); every committed TIFF variant decoded
              bitwise OpenCV's decode, every refused one naming item 14.
              (b) ``python -m jama16_retina_tpu_torch.preprocess_eyepacs``
              on 99 names (4:3 JPEG photos whose disc is downscaled at
              299 px, grades cycling, one missing, one blank, one
              unreadable) at ``--workers 2`` (JPEG), again at 0, and with
              ``--encoding raw --workers 0``: the printed report and every
              shard and ``quality_<split>.csv`` bitwise what the
              reference's ``preprocess_eyepacs.py`` wrote. (c)
              ``preprocess_messidor`` on the 1440 x 960 LZW TIFF under 8
              names with a ``;`` CSV, JPEG at 2 workers and raw at 0, the
              same bar. (d) ``trainer.fit`` of ``eyepacs_binary``
              (Inception-v3, 299 px, batch 32, preset step) from (b)'s
              JPEG splits for 8 steps, evals at 4 and 8: B1 8 times, B2 =
              B3 = 0; then phase 6's card-vs-CPU evaluation of its best
              step on (c)'s ``test`` split with thresholds from (b)'s
              ``val``. (e) ``predict.main`` (fused preprocess, float32)
              on the TIFF photo, two small TIFF variants, four JPEG photos
              and a CMYK TIFF against phase 4's k=2 members: the CMYK one
              rejected as ``decode_error`` naming item 14, B4 once a
              chunk, canvases bitwise the manifest's, rows within 1e-4 of
              the CPU engine. (f) Printed, not asserted: each runner's
              photos/s at its worker count and the encoder's ms per
              299-px canvas.
18. hbm     - the card-resident ``hbm`` loader (``data/hbm_pipeline.py``)
              alone first, then a fit from it, at full width
              (``eyepacs_binary``: 299 px, batch 32, bf16); each part
              prints a start and an end line. (a) A raw train split of
              4,096 records (1.10 GB resident), written by 8
              ``write_synthetic_split`` processes at once (seeds 1-8, 2
              shards each), and 32 val: ``load_split_numpy`` at 1 decode
              thread and at the automatic count, bitwise equal; rows
              decoded a second at each, the upload's ms and the card
              bytes it took (``memory_allocated``), the gather's ms a
              batch. (b) ``train_batches`` from step 0 across the epoch
              boundary (130 batches) and from a skip past it (4 batches),
              each bitwise the host's numpy gather of the decoded rows by
              the epoch's threefry permutation. (c) ``load_split_numpy``
              of phase 14's JPEG splits (the 317-px records through
              INTER_LINEAR) at 1 thread and the automatic count, bitwise
              ``tests/data/jpeg/hbm_load.json``, recorded from the
              reference's cv2 decode. (d) ``trainer.fit`` with
              ``data.loader=hbm`` (cuDNN deterministic): 8 preset steps,
              evals at 4 and 8 from the val cache, B1 = 8 (counts set to 0
              just before each fit and read just after); the same run
              cut by ``trainer.step`` at call 5 (B1 = 4) and resumed from
              4 (B1 = 4), its step-8 state digest equal to the
              uninterrupted run's; 4 fused steps, B2 = B3 = 4; the val
              eval of the step-8 state streamed, filling the cache and
              from it, bitwise, with each one's ms. (e) A ``tfrecord.read``
              corrupt plan on call 7 at one decode thread:
              ``data.quarantined.decode_error`` 1, an epoch of batches
              bitwise the host reference with record 6 replaced by record
              7, the ``data_quarantine`` alert firing at
              ``obs.quarantine_alert_per_s=0.001``; with
              ``data.quarantine_bad_records=false`` the load raises. (f)
              ``data.hbm_budget_bytes=1000000`` refuses the val split with
              the reference's message.

19. tiered  - the ``tiered`` loader (``data/tiered_pipeline.py``), the
              ``rawshard`` transcode and loader (``data/rawshard.py``,
              ``python -m jama16_retina_tpu_torch.transcode_shards``) and
              the ingest autotuner (``data/autotune.py``), alone first,
              then in fits, on phase 18's splits (removed after it); each
              part prints a start and an end line. Half the split's bytes
              are the budget (2,048 rows): 128 steps an epoch, 16
              resident and 16 streamed rows a batch. (a) The plan; the
              resident tier decoded and uploaded alone (ms, card bytes);
              the streamed tier alone (residency 0, 10 batches); then 134
              batches at skips 0 and 130 (each across an epoch
              boundary) at 1 and 7 decode threads, each bitwise
              ``host_reference_batches``, with ``data.tiered.decode_batch_s``
              p50. (b) The transcode CLI in a subprocess (seconds,
              rows/s), run again reusing every shard; the rawshard
              loader's 134 batches bitwise the tiered loader's, and its
              decode p50 against (a)'s. (c) From each loader (cuDNN
              deterministic, the tuner's pessimal knobs set by hand: 1
              decode thread, stage depth 1, prefetch 1): 8 preset steps,
              evals at 4 and 8 from the val cache, B1 = 8; the same run
              cut by ``trainer.step`` at call 5 (B1 = 4) and resumed (B1
              = 4) to an equal step-8 state digest; 4 fused steps, B2 =
              B3 = 4; the val eval of the step-8 state streamed and from
              the cache, bitwise. (d) (c)'s tiered preset fit with
              ``data.autotune=true``: losses and AUCs bitwise the
              hand-set fit's; the tuner's adjustments and knobs. (e) A
              ``tfrecord.read`` corrupt plan aimed at batch 0's third
              streamed record (the loader's call 2,051, the host
              reference's call 19): quarantined and substituted, 4
              batches bitwise the poisoned reference; then shard 8
              (records 2,048-2,303) damaged in a copy of (b)'s shards:
              every streamed read of it quarantined and replaced by
              record 2,304, 4 batches bitwise the shard rows so.

20. grain   - the ``grain`` loader (``data/grain_index.py``,
              ``data/grain_pipeline.py``, the trainer's worker-mode resume)
              alone first, then in fits, on phase 6's splits (64 train
              records, batch 32: 2 batches an epoch), then progressive
              JPEG; each part prints a start and an end line. (a)
              ``IndexSampler``'s first 2 epochs at seeds 0 and 42 (grain's
              ``index_shuffle`` of each), bitwise the digests recorded
              from grain in ``tests/data/grain_order.json`` (this machine has no grain).
              (b) ``train_batches`` at seed 42 in process and with 2 worker
              processes for 130 batches, each bitwise the host reference
              (the order worked out apart from the iterator, rows decoded
              once by ``_decode_example``), the ``get_state()`` bytes after
              batches 3 and 130 bitwise the reference's digests; 4 batches
              from ``skip_batches=3`` (in process) and from the state after
              batch 3 through ``set_state`` (both), past the epoch
              boundary, bitwise and with the uninterrupted run's state. (c)
              Per worker count (0, 2; cuDNN deterministic): 8 preset steps,
              evals at 4 and 8, B1 = 8 (counts set to 0 just before, read
              just after); the same run cut by ``trainer.step`` at call 5
              (B1 = 4) and resumed (B1 = 4), in process through
              ``state_at_step`` and with workers from ``grain_state/4.json``
              (bitwise the uninterrupted run's file), to an equal step-8
              state digest; then 4 fused steps in process, B2 = B3 = 4.
              (d) Every progressive fixture bitwise its manifest digests
              on the host path, the records path (``parse_record``) and,
              for the square one, ``_decode_example``; each cut in half
              refused as truncated; ``predict --images`` with
              ``serve.fused_preprocess=true`` on the progressive photo and
              a baseline one against phase 4's members: both kept, B4 once
              per chunk, canvases bitwise the manifest's, rows within 1e-4
              of the CPU engine.

21. lifecycle - the lifecycle controller (``lifecycle/``) and
              ``lifecycle_run`` at full width on phase 6's splits:
              ``eyepacs_binary`` (Inception-v3, 299 px, batch 32, bf16), k = 2
              random members with calibrated BatchNorm statistics, the fused
              preprocess, a canary of 8 canvases and a profile of the val
              scores pinned through a probe engine, retrain_steps 4,
              gate_eval_rows 32, shadow_fraction 1, shadow_requests 2, one
              watch probe, the parity and AUC bounds opened (random members);
              cuDNN deterministic; each part prints a start and an end line.
              (a) A drifted score window fires ``quality_drift`` and
              ``AlertManager(on_fire=ctl.on_alert)`` opens a cycle; the
              default retrain warm-starts both members (B1 = 8); the three
              gates pass, their values printed; a client thread sends batch-8
              requests through the micro-batcher while the rollout runs, and
              the shadow must count 2 of them (a timed-out window fails);
              WATCH and COMMIT; no request failed, the live pointer names
              the candidates, the probabilities after the swap bitwise the
              candidate's before it. (b) Freshly initialised members against
              a canary bound of 1e-6: GATE rejects, ROLLBACK unswapped, live
              probabilities bitwise unchanged. (c) A fused retrain (B2 = B3 =
              8), the promote, then a watch rule on a gauge the phase sets:
              ROLLBACK through the retained generation, probabilities bitwise
              those before the cycle, the canary reference and artifact
              restored. (d) ``python -m jama16_retina_tpu_torch.lifecycle_run
              --trigger``, ``--watch`` SIGKILLed (its session reaped) once
              member_00's marker exists, ``--watch`` again to COMMIT:
              member_00's marker bytes unchanged, member_01 fitted by the
              rerun, ``--status --json`` one cycle ending in COMMIT. (e) A
              ``lifecycle.gate`` plan fails GATE closed to ROLLBACK; a
              ``lifecycle.swap`` plan holds the journal at GATE with the old
              model serving and its canary reference, and the rerun commits.
              B4 once a chunk the engine served or scored, and once a chunk
              of the retrains' evals (each part's counts set to 0 just
              before it, read just after); the phase's peak device memory.

22. data-parallel - run right after phase 6 and beside phase 8, on phase 6's
              splits: training over
              two ranks that share the card (one card: gloo, whose
              all-reduce and broadcast take CUDA tensors; NCCL refuses two
              ranks on one device);
              each launch prints a start and an end line and is stopped
              after ``DP_LAUNCH_S``. (a) Two ranks (``launch_local``) each
              take one ``eyepacs_binary`` step of each form on their 2 rows
              of a batch of 4 at 299 px: the float64 forward and backward
              (dropout on, the draws the global batch's; B1 or B2 on the
              rank's rows), the cross-replica BatchNorm moments and the
              gradient mean, then the float32 update (plain AdamW or B3);
              rank 0 then takes the one-process step on the 4 rows: loss,
              gradients, running statistics and updated params within 1e-6
              (per-leaf relative L2), both replicas' hashes equal. (b)
              ``python -m torch.distributed.run --standalone
              --nproc_per_node 2`` of the train CLI (``dp_train_rank``: cuDNN
              deterministic, each step's replica hash and each rank's
              launches recorded) with ``parallel.num_devices=2``: 6 preset
              steps of batch 32 (16 a rank), bf16, evals at 3 and 6 under
              ``eval.sharded``: B1 6 a rank, replica hashes equal after
              every step, rank 0 alone writing; the same fit cut by a
              ``trainer.step`` plan at call 4 and resumed from 3: its
              ``latest/`` and ``best/`` bitwise the uncut run's. (c) 4 fused
              steps: B2 = B3 = 4 a rank. (b)'s uncut fit, (c) and (b)'s cut
              fit run in turn in one launch (one process group; the first
              two alone on the card); the second part, (b)'s resume in a
              second launch beside (a), runs beside phase 8, whose checks
              read no clock (its wall times then include the sharing). The backend, each rank's device and the
              step times of (b) and (c) beside phase 6's one-rank step (two
              ranks on one card measure agreement, not scaling).

The last two lines are the card's ``nvidia-smi`` name and power limit and
``{"ok": true, "device": {...}}``; before them come the kernels' JSON
record (every kernel's ``launches`` from phases 21 and 22: B1 from 21
(a)'s retrain and 22 (b)'s uncut fit, B2 and B3 from 21 (c)'s fused
retrain and 22 (c)'s fit, both ranks summed, B4 phase 21's; each phase's
launches on a line of its own (18-22), and each kernel's launches on
every path, ``launches_by_phase``) and the run's seconds. Scratch files go under ``build/chip_smoke``
(git-ignored). Without a CUDA card, or run outside a checkout of the
repository (no ``jama16_retina_tpu_torch`` to import), it exits 1 before
printing any result.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCRATCH = ROOT / "build" / "chip_smoke"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM at 700 W, published
FP32_FLOPS_PER_S = 67e12      # the same, float32 outside tensor cores
REQUESTS = (1, 8, 13)
KERNEL_SHAPES = ((8, 299, 299, 3), (16, 299, 299, 3), (64, 299, 299, 3),
                 (3, 37, 53, 3))
JITTER_SHAPES = ((32, 299, 299, 3), (3, 37, 53, 3))
B2_SHAPES = {(32, 299, 299, 3): "single_pass", (3, 37, 53, 3): "single_pass",
             (1, 1, 1, 3): "single_pass", (5, 17, 23, 3): "single_pass",
             (1, 1536, 1536, 3): "two_pass"}
B2_TURNS = ("two_pass", 8, 16, 16, 8, "two_pass")
TRAIN_BATCH = 32
TRAIN_IMAGES = 64
TRAIN_STEPS = 8
TRAIN_FORMS = {"preset": [], "fused": ["train.use_pallas_fused=true"]}
# (split, images, shards, seed) of the fit phase's TFRecord splits.
FIT_SPLITS = (("train", 64, 4, 1), ("val", 32, 2, 2), ("test", 32, 2, 3))
FIT_STEPS = 8
FIT_EVAL_EVERY = 4
# Presets of phase 8, and the presets whose leaf sets B3 is held over.
MODEL_PRESETS = ("resnet50", "efficientnet_b4", "icdr5")
MODEL_STEPS = 2
B3_PRESETS = ("eyepacs_binary", "resnet50", "efficientnet_b4", "icdr5")
ICDR5_STEPS = 4
# Phase 20: the grain loader over phase 6's train split (records, batch,
# image size), at a fixed seed, in-process and with 2 worker processes:
# 130 batches from 0, the state digests after batches 3 and 130
# (tests/data/grain_order.json, recorded from the reference), a skip and
# a restored state past the epoch boundary, 4 batches each.
GRAIN_RECORDS = 64
GRAIN_BATCH = 32
GRAIN_SIZE = 299
GRAIN_SEED = 42
GRAIN_WORKERS = (0, 2)
GRAIN_BATCHES = 130
GRAIN_STATE_AT = (3, GRAIN_BATCHES)
GRAIN_RESUMED = 4
# Phase 9: timed steps per form after 2 warm, the accumulation counts, and
# the train stream's (prefetch depth, reader processes) in turns.
KNOB_STEPS = 4
ACCUM = (1, 2, 4)
STREAM_TURNS = ((0, 1), (2, 1), (2, 2), (0, 1))
STREAM_STEPS = 6
# The last BatchNorm of a residual branch (ResNet-50's bn3, EfficientNet's
# project_bn): random members draw its scale in [0.05, 0.15].
RESIDUAL_LAST_BN = (".bn3.scale", ".project_bn.scale")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
        raise SystemExit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_member(model, gen):
    """Seeded random weights and BN statistics for a port model: He-normal
    convs, 1/sqrt(fan_in) Dense, small biases, BN var and scale in
    [0.5, 1.5], but the scale of a residual branch's last BN in
    [0.05, 0.15] (the small-scale residual init of Goyal et al. 2017: a
    random residual stack with scales near 1 amplifies a rounding
    difference about 1.3x a block)."""
    import torch

    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(".var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif name.endswith(RESIDUAL_LAST_BN):
                t.copy_(0.05 + 0.1 * torch.rand(t.shape, generator=gen))
            elif name.endswith(".scale"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif name.endswith((".mean", ".bias")):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
            elif t.ndim == 4:
                fan_in = t.shape[1] * t.shape[2] * t.shape[3]
                t.copy_(torch.randn(t.shape, generator=gen)
                        * (2.0 / fan_in) ** 0.5)
            elif t.ndim == 2:
                t.copy_(torch.randn(t.shape, generator=gen) / t.shape[1] ** 0.5)
            else:
                raise ValueError(f"unexpected tensor {name}")
    return model


def event_ms(fn, reps: int) -> float:
    """Mean ms per ``fn(i)`` call by CUDA events: the card's wall time per
    call, which includes any wait for the host to enqueue the next one."""
    import torch

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_events(fn, reps: int, match) -> "tuple[int, float]":
    """(events, summed device us) of the device operations (kernels,
    memsets, copies) that ``fn(0) .. fn(reps - 1)`` issue and ``match``
    accepts by name, from one CUDA-only ``torch.profiler`` trace. The
    calls sit between sentinel kernels (``torch.cuda._sleep``'s
    ``spin_kernel``, two before and two after, not counted): a trace was
    seen to lose its second event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
        for _ in range(2):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.self_device_time_total > 0 and match(e.key)
              and "spin_kernel" not in e.key]
    return (sum(e.count for e in events),
            sum(e.self_device_time_total for e in events))


def device_ms(fn, reps: int, kernel: "str | None" = None,
              launches: int = 1, strict: bool = True) -> float:
    """Mean device-busy ms per ``fn(i)`` call, from a CUDA-only
    ``torch.profiler`` trace. Host time between launches is not counted.

    With ``kernel`` (a whole word of the event's name): the mean duration
    of that kernel's events times its ``launches`` a call. Without: the
    summed durations of every device operation over ``reps``.

    Each trace's events are counted, as the profiler drops some in some
    process states, and dividing a short trace's sum by ``reps`` reports
    a time under the kernel's bound. A kernel's trace should hold ``reps``
    x ``launches`` events, a plain version's (whose operations a call
    cannot be told in advance) a multiple of ``reps``. A short trace is
    taken again once; then the fuller is kept, its count printed (the
    profiler has been seen to drop the same one event every time): a kernel's time is a mean over the
    events seen, so a lost event does not bias it, and a plain version's
    hundreds of operations a call move by well under 1 % for one event.
    A kernel's trace that kept under half its events fails the run. With
    ``strict`` off (whole steps and requests, whose thousands of kernels
    vary by a few from call to call) one trace is taken, unchecked, after
    one warm call (their callers have run them warm already)."""
    import torch

    match = ((lambda key: True) if kernel is None else re.compile(
        rf"(?<![A-Za-z0-9_]){re.escape(kernel)}\b").search)
    for i in range(3 if strict else 1):
        fn(i)
    torch.cuda.synchronize()
    want = reps * launches
    n, us = 0, 0.0
    attempts = 2 if strict else 1
    for attempt in range(attempts):
        got = _device_events(fn, reps, match)
        whole = (got[0] == want if kernel
                 else got[0] > 0 and got[0] % reps == 0)
        if whole or not strict:
            n, us = got
            break
        if got[0] > n:
            n, us = got
        log(f"times: a trace of {reps} calls held {got[0]} events of "
            f"{kernel or 'the device'}, "
            f"{want if kernel else f'a multiple of {reps}'} expected"
            + ("; taken again" if attempt < attempts - 1
               else f"; the fullest ({n}) kept"))
    if kernel is None:
        check(n > 0, f"{attempts} trace(s) of {reps} calls held no device "
              f"event")
        return us / reps / 1e3
    check(2 * n >= want, f"a trace of {reps} calls kept {n} of its {want} "
          f"events of {kernel}")
    return us / n * launches / 1e3


def below_bound(t: dict) -> str:
    """The flag printed beside a kernel time under its bound: such a time
    is a measurement fault, not a fast kernel."""
    return " BELOW_BOUND" if t["ms"] < t["bound_ms"] else ""


def phase_kernels(torch, sp, dev, seed: int) -> float:
    worst = 0.0
    gen = torch.Generator(device=dev).manual_seed(seed)
    for shape in KERNEL_SHAPES:
        imgs = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)
        norm_k, sums_k = sp.fused_serve_preprocess(imgs)
        torch.cuda.synchronize()
        norm_p, sums_p = sp.serve_preprocess_reference(imgs)
        err = float((norm_k - norm_p).abs().max())
        worst = max(worst, err)
        check(torch.equal(norm_k, norm_p),
              f"fused_serve_preprocess rows differ at {shape}: max {err}")
        check(torch.equal(sums_k, sums_p),
              f"fused_serve_preprocess sums differ at {shape}")
        log(f"kernels: fused_serve_preprocess {list(shape)} rows bitwise, "
            "sums exact")
    return worst


def jitter_inputs(torch, dev, shape, gen):
    """Random uint8 images and colour params for B1 and B2 at ``shape``."""
    from jama16_retina_tpu_torch.ops import color_jitter as cj

    b = shape[0]
    imgs = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                         generator=gen)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(b, generator=gen, device=dev)

    sat, theta, contrast, bright = (u(0.8, 1.2), u(-0.3, 0.3),
                                    u(0.75, 1.25), u(-0.25, 0.25))
    m = cj.chroma_matrix(sat, theta)
    affine, offset = cj.color_affine_from_params(
        cj.channel_means_u8(imgs), bright, contrast, sat, theta)
    return imgs, (affine, offset), (m, contrast, bright)


def device_ops(torch, fn, warm: bool = True) -> list:
    """(name, count) of every device operation (kernel, memset, copy) that
    one ``fn()`` call issues, from a CUDA-only ``torch.profiler`` trace
    (after one untraced call when ``warm``). The call sits between
    sentinel kernels, not counted, as in ``_device_events``: a trace of
    one call was seen to come back empty."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        for _ in range(2):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    return [(e.key, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0 and "spin_kernel" not in e.key]


def phase_jitter_kernels(torch, dev, seed: int) -> dict:
    """B1 and B2 bitwise against their plain versions, B2 on both routes,
    and one single-pass B2 call traced to one device kernel."""
    from jama16_retina_tpu_torch.ops import color_jitter as cj

    worst = {"fused_color_jitter": 0.0, "fused_normalize_color_jitter": 0.0}
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def held(name, got, want, what):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst[name] = max(worst[name], err)
        check(torch.equal(got, want),
              f"{name} differs from its plain version at {what}: max {err}")
        log(f"kernels: {name} {what} bitwise")

    for shape in JITTER_SHAPES:
        imgs, b1_args, _ = jitter_inputs(torch, dev, shape, gen)
        held("fused_color_jitter", cj.fused_color_jitter(imgs, *b1_args),
             cj.color_jitter_reference(imgs, *b1_args), list(shape))
    for shape, route in B2_SHAPES.items():
        plan = cj._b2_plan(*shape[1:3])
        check(plan.route == route,
              f"B2 at {shape} planned {plan}, want the {route} route")
        imgs, _, b2_args = jitter_inputs(torch, dev, shape, gen)
        held("fused_normalize_color_jitter",
             cj.fused_normalize_color_jitter(imgs, *b2_args),
             cj.normalize_color_jitter_reference(imgs, *b2_args),
             f"{list(shape)} ({route}, cluster {plan.cluster})")
    imgs, _, b2_args = jitter_inputs(torch, dev, (TRAIN_BATCH, 299, 299, 3),
                                     gen)
    ops = device_ops(torch, lambda: cj.fused_normalize_color_jitter(
        imgs, *b2_args))
    log(f"kernels: one single-pass fused_normalize_color_jitter call at "
        f"[{TRAIN_BATCH}, 299, 299, 3] issues {ops}")
    check(len(ops) == 1 and ops[0][1] == 1
          and "normalize_color_jitter_cluster_kernel" in ops[0][0],
          f"a single-pass B2 call issued {ops}, want one cluster kernel")
    return worst


def model_leaves(torch, dev, seed: int, preset: str = "eyepacs_binary"):
    """The parameter leaves of the preset's model (299 px) as the train
    state holds them (channels_last convs), with random grads, and their
    decay flags."""
    from jama16_retina_tpu_torch import configs, models
    from jama16_retina_tpu_torch.models import init

    cfg = configs.get_config(preset)
    model = init.init_flax_default(models.build(cfg.model), seed).to(
        dev, memory_format=torch.channels_last)
    params = [p.detach().clone() for p in model.parameters()]
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    grads = [torch.randn(p.shape, generator=gen, device=dev).contiguous(
        memory_format=torch.channels_last if p.ndim == 4
        else torch.contiguous_format) for p in params]
    return params, grads, [p.ndim >= 2 for p in params]


def b3_launches_per_call(n_leaves: int) -> int:
    from jama16_retina_tpu_torch.ops import adamw

    return -(-n_leaves // adamw._library()[1])


def phase_adamw_kernel(torch, dev, seed: int) -> float:
    """B3 bitwise against the plain AdamW over every leaf of each model of
    ``B3_PRESETS``, three steps from zero moments, with the launches of
    each call counted (one per 400 leaves: EfficientNet-B4's 418 take
    two)."""
    from jama16_retina_tpu_torch.ops import adamw

    worst = 0.0
    for preset in B3_PRESETS:
        pk, grads, decay = model_leaves(torch, dev, seed, preset)
        pp = [p.clone() for p in pk]
        mk, vk, mp, vp = ([torch.zeros_like(p) for p in pk] for _ in range(4))
        n = sum(p.numel() for p in pk)
        want = b3_launches_per_call(len(pk))
        for step in range(3):
            t = torch.tensor(float(step + 1), device=dev)
            scalars = torch.stack([torch.tensor(1e-3, device=dev),
                                   1.0 / (1.0 - torch.pow(0.9, t)),
                                   1.0 / (1.0 - torch.pow(0.999, t))])
            before = adamw.launches
            adamw.fused_adamw_update(pk, grads, mk, vk, decay, scalars, 4e-5)
            torch.cuda.synchronize()
            check(adamw.launches - before == want,
                  f"B3 over {len(pk)} leaves launched "
                  f"{adamw.launches - before} times, want {want}")
            adamw.adamw_reference(pp, grads, mp, vp, decay, scalars, 4e-5)
            for a, b in zip(pk + mk + vk, pp + mp + vp):
                worst = max(worst, float((a - b).abs().max()))
                check(torch.equal(a, b), "fused_adamw_update differs from "
                      f"its plain version at step {step + 1} ({preset})")
        log(f"kernels: fused_adamw_update {preset}: {len(pk)} leaves, {n} "
            f"elements, {want} launch(es) a call, 3 steps bitwise")
    return worst


def kernel_times(torch, sp, dev, batch: int) -> dict:
    """Kernel and plain-version times at [batch, 299, 299, 3], cycling
    over at least 3 input sets that together exceed twice the 50 MB L2,
    so each call reads cold input as the serve path's freshly copied
    chunk would.
    ``ms``/``plain_ms`` are device time; ``call_ms``/``plain_call_ms``
    the card's wall time per call, host enqueue included."""
    shape = (batch, 299, 299, 3)
    per_call = batch * 299 * 299 * 3 * 5  # u8 in + f32 out
    n_sets = max(3, -(-100_000_000 // per_call))
    gen = torch.Generator(device=dev).manual_seed(1)
    sets = [torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=gen) for _ in range(n_sets)]
    reps = 50

    def kernel(i):
        sp.fused_serve_preprocess(sets[i % n_sets])

    def plain(i):
        sp.serve_preprocess_reference(sets[i % n_sets])

    n = batch * 299 * 299 * 3
    bytes_ms = (n * 5 + batch * 4 * 8) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * n / FP32_FLOPS_PER_S * 1e3
    return {"shape": list(shape),
            "ms": device_ms(kernel, reps, "serve_preprocess_kernel", 1),
            "plain_ms": device_ms(plain, reps),
            "call_ms": event_ms(kernel, reps),
            "plain_call_ms": event_ms(plain, reps),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def jitter_times(torch, dev) -> dict:
    """B1 and B2 device time (kernel and plain version) at the train
    batch [32, 299, 299, 3], cycling over input sets that together exceed
    the 50 MB L2, beside the bound: each input byte read once and each
    output written once. B2's routes run in the turns of ``B2_TURNS`` on
    the same inputs: its two-pass route, and its single-pass route at
    clusters of 8 and 16 blocks (the kept size, ``B2_CLUSTER``, is B2's
    ``ms``). ``yardstick_ms`` is ``images.to(torch.float32)``: it moves the
    same bytes (a PyTorch elementwise kernel's reach on this traffic) but
    does not compute B2's function, so it is not ``library_ms``."""
    from jama16_retina_tpu_torch.ops import color_jitter as cj

    shape = (TRAIN_BATCH, 299, 299, 3)
    gen = torch.Generator(device=dev).manual_seed(3)
    sets = [jitter_inputs(torch, dev, shape, gen) for _ in range(3)]
    pixels = TRAIN_BATCH * 299 * 299
    bytes_ms = (pixels * 15 + TRAIN_BATCH * 12 * 4) / HBM_BYTES_PER_S * 1e3

    def run(fn, which):
        return lambda i: fn(sets[i % 3][0], *sets[i % 3][which])

    def bound(ops):
        ops_ms = ops * pixels / FP32_FLOPS_PER_S * 1e3
        return {"bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}

    out = {"fused_color_jitter": {
        "shape": list(shape),
        "ms": device_ms(run(cj.fused_color_jitter, 1), 50,
                        "color_jitter_kernel", 1),
        "plain_ms": device_ms(run(cj.color_jitter_reference, 1), 20),
        **bound(30), "library_ms": None}}
    plans = {t: cj._TWO_PASS if t == "two_pass" else cj._b2_plan(
        299, 299, cluster=t) for t in B2_TURNS}
    turns = {t: [] for t in plans}
    for t in B2_TURNS:
        plan = plans[t]
        named = ({} if plan.route == "two_pass" else {
            "kernel": "normalize_color_jitter_cluster_kernel",
            "launches": 1})
        turns[t].append(device_ms(
            lambda i, plan=plan: cj._launch_b2(sets[i % 3][0],
                                               *sets[i % 3][2], plan), 50,
            **named))
    kept = plans[cj.B2_CLUSTER]
    out["fused_normalize_color_jitter"] = {
        "shape": list(shape),
        "ms": statistics.mean(turns[cj.B2_CLUSTER]),
        "plain_ms": device_ms(run(cj.normalize_color_jitter_reference, 2),
                              20),
        **bound(33), "library_ms": None,
        "plan_route": kept.route, "cluster": kept.cluster,
        "two_pass_ms": statistics.mean(turns["two_pass"]),
        "turns_ms": {str(t): v for t, v in turns.items()},
        "yardstick_ms": device_ms(
            lambda i: sets[i % 3][0].to(torch.float32), 50)}
    return out


def adamw_times(torch, dev, seed: int, preset: str = "eyepacs_binary"
                ) -> dict:
    """B3 device time over the preset model's leaf set against its bound
    (28 bytes per element: p, g, mu, nu read, p, mu, nu written), the
    plain version, and ``torch.optim.AdamW(fused=True)`` over the same
    tensors in two param groups (decayed, undecayed): PyTorch's own
    fused AdamW, timed as a yardstick and never called by the port."""
    from jama16_retina_tpu_torch.ops import adamw

    params, grads, decay = model_leaves(torch, dev, seed, preset)
    mu, nu = ([torch.zeros_like(p) for p in params] for _ in range(2))
    scalars = torch.tensor([1e-3, 10.0, 1000.0], device=dev)
    n = sum(p.numel() for p in params)
    bytes_ms = 28 * n / HBM_BYTES_PER_S * 1e3
    ops_ms = 15 * n / FP32_FLOPS_PER_S * 1e3

    def kernel(i):
        adamw.fused_adamw_update(params, grads, mu, nu, decay, scalars, 4e-5)

    def plain(i):
        adamw.adamw_reference(params, grads, mu, nu, decay, scalars, 4e-5)

    lib_params = [torch.nn.Parameter(p.clone()) for p in params]
    for q, g in zip(lib_params, grads):
        q.grad = g
    opt = torch.optim.AdamW([
        {"params": [q for q, d in zip(lib_params, decay) if d],
         "weight_decay": 4e-5},
        {"params": [q for q, d in zip(lib_params, decay) if not d],
         "weight_decay": 0.0}], lr=1e-3, fused=True)
    return {"preset": preset, "leaves": len(params), "elements": n,
            "launches_per_call": b3_launches_per_call(len(params)),
            "ms": device_ms(kernel, 20, "adamw_kernel",
                            b3_launches_per_call(len(params))),
            "plain_ms": device_ms(plain, 5),
            "library_ms": device_ms(lambda i: opt.step(), 20),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def launch_counts() -> dict:
    from jama16_retina_tpu_torch.ops import adamw
    from jama16_retina_tpu_torch.ops import color_jitter as cj
    from jama16_retina_tpu_torch.ops import serve_preprocess as sp

    return {**cj.launches, "fused_adamw_update": adamw.launches,
            "fused_serve_preprocess": sp.launches}


def reset_launch_counts() -> None:
    from jama16_retina_tpu_torch.ops import adamw
    from jama16_retina_tpu_torch.ops import color_jitter as cj
    from jama16_retina_tpu_torch.ops import serve_preprocess as sp

    cj.launches.update(dict.fromkeys(cj.launches, 0))
    adamw.launches = 0
    sp.launches = 0


def calibrate(torch, model, canvases) -> None:
    """Set every BatchNorm's running statistics of ``model`` (float32)
    to the batch statistics of the uint8 ``canvases``: one train-mode
    forward on the card at momentum 0, with no stochastic depth, as a
    trained network's statistics describe its own activations. Random
    statistics do not normalize, so the eval logits of a deep residual
    stack reach hundreds, where probabilities saturate and a card-vs-CPU
    comparison says nothing. The model is written out and dropped
    after."""
    from jama16_retina_tpu_torch.data import augment
    from jama16_retina_tpu_torch.models.common import BatchNorm

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.momentum = 0.0
        if hasattr(m, "drop_rate"):
            m.drop_rate = 0.0
    model.cuda()
    with torch.no_grad():
        x = augment.normalize(torch.from_numpy(canvases).cuda())
        model(x.permute(0, 3, 1, 2), train=True)
    model.cpu()


def render(seed: int, n: int):
    """n rendered fundus canvases at 299 px, grades cycling 0-4."""
    import numpy as np

    from jama16_retina_tpu_torch.data import synthetic

    synth = synthetic.SynthConfig(image_size=299)
    return np.stack([synthetic.render_fundus(np.random.default_rng(seed + i),
                                             i % 5, synth)
                     for i in range(n)])


def phase_serve(torch, seed: int, preset: str = "eyepacs_binary",
                cpu_rows: tuple = REQUESTS) -> dict:
    """k=2 random members of the preset's model as member dirs; a float32
    engine with the fused preprocess answers requests of ``REQUESTS``
    canvases on the card (launch counts set to 0 just before, read just
    after), those of ``cpu_rows`` held against the same engine on the
    CPU; the preset's bf16 engine is compared with it (reported)."""
    from jama16_retina_tpu_torch import configs, models
    from jama16_retina_tpu_torch.models import convert
    from jama16_retina_tpu_torch.ops import serve_preprocess as sp
    from jama16_retina_tpu_torch.serve.engine import ServingEngine
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
    import numpy as np

    bf16_cfg = configs.override(configs.get_config(preset),
                                ["serve.fused_preprocess=true"])
    cfg = configs.override(bf16_cfg, ["model.compute_dtype=float32"])
    multi = cfg.model.head == "multi"
    calibrated = cfg.model.arch in ("resnet50", "efficientnet_b4")
    dirs = []
    for m in range(2):
        model = random_member(models.build(cfg.model),
                              torch.Generator().manual_seed(seed + m))
        if calibrated:
            calibrate(torch, model, render(seed + 200 + 16 * m, 16))
        d = SCRATCH / "members" / preset / f"member_{m:02d}"
        ckpt_lib.save_member(str(d), convert.torch_to_flax(model))
        dirs.append(str(d))
    how = ", BN statistics calibrated on 16 canvases" if calibrated else ""
    log(f"serve {preset}: wrote {len(dirs)} member dirs of "
        f"{sum(p.numel() for p in model.parameters())} parameters "
        f"({cfg.model.arch}, head {cfg.model.head}{how})")

    canvases = render(seed + 100, sum(REQUESTS))
    offsets = np.cumsum((0,) + REQUESTS)
    requests = [canvases[a:b] for a, b in zip(offsets[:-1], offsets[1:])]

    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(cfg, dirs, device="cuda")
    # The main path: counts set to 0 just before, read just after.
    reset_launch_counts()
    engine.chunks_dispatched = 0
    gpu = [engine.probs(r) for r in requests]
    counts = launch_counts()
    launches = counts["fused_serve_preprocess"]
    chunks = engine.chunks_dispatched
    log(f"serve {preset}: {len(requests)} requests of {list(REQUESTS)} rows "
        f"-> {chunks} chunks; launches {counts}")
    check(launches > 0, "the serve path launched no fused_serve_preprocess")
    check(launches == chunks,
          f"{launches} kernel launches for {chunks} dispatched chunks")
    check(sum(counts.values()) == launches,
          f"the serve path launched a train kernel: {counts}")
    for r, p in zip(requests, gpu):
        want_shape = (r.shape[0], 5) if multi else (r.shape[0],)
        check(p.shape == want_shape, f"probs shape {p.shape}")
        check(bool(np.all(np.isfinite(p)) and np.all((p >= 0) & (p <= 1))),
              f"probabilities not finite in [0, 1]: {p}")
        if multi:
            rows = float(np.max(np.abs(p.sum(axis=1) - 1.0)))
            check(rows <= 1e-6, f"5-class rows sum to 1 within {rows}")
    if multi:
        log(f"serve {preset}: every [n, 5] row sums to 1 within 1e-6")
    want_stats = sp.input_stats_dict(sp.stats_from_sums(
        sp.serve_preprocess_reference(torch.from_numpy(requests[-1]))[1],
        299 * 299))
    for k, v in want_stats.items():
        check(np.array_equal(engine.last_input_stats[k], v),
              f"input stat {k} of the last request differs from the host's")

    cpu = ServingEngine(cfg, dirs, device="cpu")
    dev_cpu = max(float(np.max(np.abs(cpu.member_probs(r)
                                      - engine.member_probs(r))))
                  for r in requests if len(r) in cpu_rows)
    log(f"serve {preset}: float32 card vs CPU max |member prob diff| "
        f"{dev_cpu:.3e} over requests of {list(cpu_rows)} rows (atol 1e-4, "
        "TF32 off)")
    check(dev_cpu <= 1e-4, f"card and CPU disagree by {dev_cpu}")
    del cpu

    bf16 = ServingEngine(bf16_cfg, dirs, device="cuda")
    bf16_probs = [bf16.probs(r) for r in requests]
    dev_bf16 = max(float(np.max(np.abs(a - b)))
                   for a, b in zip(bf16_probs, gpu))
    check(all(np.all(np.isfinite(p)) for p in bf16_probs), "bf16 not finite")
    log(f"serve {preset}: bf16 preset vs float32 max |prob diff| "
        f"{dev_bf16:.3e} (reported, not asserted)")
    engines = {"float32": (cfg, engine), "bfloat16": (bf16_cfg, bf16)}
    return {"launches": counts, "chunks": chunks, "dirs": dirs,
            "canvases": canvases, "engines": engines,
            "max_dev_cpu": dev_cpu, "max_dev_bf16": dev_bf16}


def request_times(torch, serve: dict, card: str, name: str = "",
                  dtypes=("float32", "bfloat16"), ks=(1, 2)) -> None:
    """Host-clock request latency around a synchronizing ``probs`` call,
    per dtype, batch 8 and 64, k = 1 and 2 (medians of 10 after 2 warm),
    and the device's busy time per request (profiler, 1 request), whose
    complement is the share of the request the card sat idle."""
    from jama16_retina_tpu_torch.serve.engine import ServingEngine
    import numpy as np

    canvases = serve["canvases"]
    for dtype in dtypes:
        cfg, engine2 = serve["engines"][dtype]
        engines = {2: engine2}
        if 1 in ks:
            engines[1] = ServingEngine(cfg, serve["dirs"][:1], device="cuda")
        for k in sorted(engines):
            engine = engines[k]
            for batch in (8, 64):
                imgs = np.resize(canvases, (batch,) + canvases.shape[1:])
                times = []
                for i in range(12):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    engine.probs(imgs)
                    torch.cuda.synchronize()
                    if i >= 2:
                        times.append((time.perf_counter() - t0) * 1e3)
                med = statistics.median(times)
                busy = device_ms(lambda i: engine.probs(imgs), 1,
                                 strict=False)
                log(f"times: request {name}{dtype} k={k} batch={batch}: "
                    f"median {med:.3f} ms, min {min(times):.3f}, max "
                    f"{max(times):.3f}; device busy {busy:.3f} ms, idle "
                    f"{100 * (1 - busy / med):.1f} % ({card})")
        del engines


def train_config(form: str, steps: int, seed: int,
                 preset: str = "eyepacs_binary"):
    from jama16_retina_tpu_torch import configs

    return configs.override(configs.get_config(preset), [
        f"train.steps={steps}", "train.log_every=1", f"train.seed={seed}",
        f"data.batch_size={TRAIN_BATCH}", *TRAIN_FORMS[form]])


def phase_train(torch, seed: int, steps: int,
                preset: str = "eyepacs_binary") -> dict:
    """The train step's main path, once per step form, through
    ``trainer.fit_synthetic`` (images held on the device)."""
    import numpy as np

    from jama16_retina_tpu_torch import models, trainer
    from jama16_retina_tpu_torch.models import convert, init
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

    cfg = train_config("preset", steps, seed, preset)
    init_flat = convert.torch_to_flax(init.init_flax_default(
        models.build(cfg.model), seed))
    n_leaves = sum(k.startswith("params/") for k in init_flat)
    b3 = steps * b3_launches_per_call(n_leaves)
    want = {"preset": {"fused_color_jitter":
                       steps if cfg.data.use_pallas else 0,
                       "fused_normalize_color_jitter": 0,
                       "fused_adamw_update": 0, "fused_serve_preprocess": 0},
            "fused": {"fused_color_jitter": 0,
                      "fused_normalize_color_jitter": steps,
                      "fused_adamw_update": b3,
                      "fused_serve_preprocess": 0}}
    out = {}
    for form in TRAIN_FORMS:
        cfg = train_config(form, steps, seed, preset)
        workdir = SCRATCH / "train" / preset / form
        shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # The main path: counts set to 0 just before, read just after.
        reset_launch_counts()
        results = trainer.fit_synthetic(cfg, str(workdir), TRAIN_IMAGES,
                                        device="cuda")
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        log(f"train {preset}: {form}: {steps} steps of batch {TRAIN_BATCH} "
            f"at 299 px on {TRAIN_IMAGES} canvases in "
            f"{results['train_sec']:.2f} s (first steps included); "
            f"launches {counts}")
        check(counts == want[form],
              f"{preset} {form} run launched {counts}, want {want[form]}")
        losses = list(results["logged_losses"].values())
        check(len(losses) == steps and bool(np.all(np.isfinite(losses))),
              f"{preset} {form} losses not finite: {losses}")
        trained = ckpt_lib.load_member(str(workdir))
        same = {k for k in init_flat if k.startswith("params/")
                and np.array_equal(trained[k], init_flat[k])}
        log(f"train {preset}: {form}: losses "
            f"{[round(x, 4) for x in losses]}; {n_leaves - len(same)} of "
            f"{n_leaves} parameter leaves changed; peak device memory "
            f"{peak} bytes")
        # EfficientNet's project_bn biases have a true gradient of 0 (only
        # train-mode BatchNorms read their output): rounding may leave
        # them exactly 0, and then AdamW does not move them.
        check(all(k.endswith("/project_bn/bias") for k in same),
              f"{preset} {form}: leaves unchanged: {sorted(same)[:5]}")
        out[form] = {"launches": counts, "losses": losses, "peak": peak}
        shutil.rmtree(workdir, ignore_errors=True)
    return out


def float64_twin(torch, model, cfg):
    """``model`` in float64 with its float32 heads, as the Flax modules
    make their heads whatever the compute dtype; dropout and stochastic
    depth 0."""
    from jama16_retina_tpu_torch.models import (efficientnet, inception_v3,
                                                resnet)

    m = cfg.model
    kw = dict(num_classes=m.num_classes, dropout_rate=0.0,
              dtype=torch.float64)
    if m.arch == "inception_v3":
        twin = inception_v3.InceptionV3(aux_head=m.aux_head,
                                        image_size=m.image_size, **kw)
    elif m.arch == "resnet50":
        twin = resnet.ResNet50(**kw)
    else:
        twin = efficientnet.EfficientNet.b4(drop_connect_rate=0.0, **kw)
    twin.load_state_dict(model.state_dict())
    twin = twin.to(torch.float64)
    for mod in twin.modules():
        if isinstance(mod, torch.nn.Linear):
            mod.float()
    return twin


def augmented_batch(torch, seed: int) -> dict:
    """One preset-augmented batch of 4 rendered canvases at 299 px, made
    on the card and on the CPU from one set of draws and compared (the
    card's cos/sin may round differently); the CPU's batch then feeds
    both devices in the agreement checks, as a 1-ulp input difference
    alone moves the float64 gradient by about 1 % (BatchNorm over small
    maps amplifies it)."""
    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.data import augment, synthetic

    cfg = configs.get_config("eyepacs_binary")
    images, grades = synthetic.make_dataset(
        4, synthetic.SynthConfig(image_size=299), seed=seed + 9)
    drawn = augment._draw_params(torch.Generator().manual_seed(seed), 4,
                                 cfg.data, "cpu")
    x = {dev: augment.augment_batch(
        None, torch.from_numpy(images).to(dev), cfg.data,
        params={k: v.to(dev) for k, v in drawn.items()}).cpu()
        for dev in ("cpu", "cuda")}
    aug_diff = float((x["cuda"] - x["cpu"]).abs().max())
    log(f"train: augmented batch 4 card vs CPU max |diff| {aug_diff:.3e} "
        "(limit 1e-6); the CPU's batch feeds both devices below")
    check(aug_diff <= 1e-6, "card and CPU augment disagree")
    return {"x": x["cpu"], "grades": torch.from_numpy(grades),
            "augment_max_abs_diff": aug_diff}


def phase_train_agreement(torch, seed: int, batch: dict,
                          preset: str = "eyepacs_binary",
                          dtypes: tuple = ("float32", "float64")) -> dict:
    """One train forward and backward (TF32 off, dropout and stochastic
    depth 0) of the preset's model on ``batch`` (batch 4, 299 px) on the
    card and on the CPU, from one init: loss and gradients compared over
    all leaves and leaf by leaf. A leaf whose CPU gradient is below 1e-9
    of the whole gradient's norm (a true gradient of 0: EfficientNet's
    ``project_bn`` biases, read only by train-mode BatchNorms) is held
    against that floor instead of its own norm."""
    import copy

    from jama16_retina_tpu_torch import configs, models, train_lib
    from jama16_retina_tpu_torch.models import init

    cfg = configs.override(configs.get_config(preset), [
        "model.compute_dtype=float32", "model.dropout_rate=0.0"])
    base = init.init_flax_default(models.build(cfg.model), seed)
    out = {}
    for name in dtypes:
        dtype = getattr(torch, name)
        loss_tol = 1e-3 if dtype == torch.float32 else 1e-6
        res = {}
        for dev in ("cpu", "cuda"):
            model = (copy.deepcopy(base) if dtype == torch.float32
                     else float64_twin(torch, base, cfg))
            model = model.to(dev, memory_format=torch.channels_last)
            logits, aux = model(
                batch["x"].to(dev).permute(0, 3, 1, 2).to(dtype), train=True)
            loss = train_lib.loss_fn(logits, aux, batch["grades"].to(dev),
                                     cfg)
            loss.backward()
            res[dev] = (loss.item(), {
                k: p.grad.detach().double().cpu().reshape(-1)
                for k, p in model.named_parameters()})
            del model
        (l_cpu, g_cpu), (l_gpu, g_gpu) = res["cpu"], res["cuda"]
        a, b = torch.cat(list(g_gpu.values())), torch.cat(list(g_cpu.values()))
        rel = float((a - b).norm() / b.norm())
        cos = float(a @ b / (a.norm() * b.norm()))
        floor = 1e-9 * float(b.norm())
        per_leaf = {k: float((g_gpu[k] - g_cpu[k]).norm()
                             / max(float(g_cpu[k].norm()), floor))
                    for k in g_cpu}
        worst = max(per_leaf, key=per_leaf.get)
        n_floor = sum(float(g.norm()) < floor for g in g_cpu.values())
        log(f"train {preset}: {name} batch 4 card vs CPU: loss "
            f"{l_gpu:.9f} vs {l_cpu:.9f} (|diff| {abs(l_gpu - l_cpu):.3e}, "
            f"limit {loss_tol:g}); gradient relative L2 {rel:.3e}, cosine "
            f"{cos:.9f}; worst of {len(per_leaf)} leaves {worst} "
            f"{per_leaf[worst]:.3e} ({n_floor} held against the floor)")
        check(abs(l_gpu - l_cpu) <= loss_tol,
              f"card and CPU {name} train losses disagree ({preset})")
        if dtype == torch.float32:
            check(rel <= 0.08 and cos >= 0.995,
                  "card and CPU float32 gradients disagree (limits: "
                  "relative L2 0.08, cosine 0.995)")
        else:
            check(per_leaf[worst] <= 1e-6,
                  f"card and CPU float64 gradients disagree in {worst} "
                  f"({preset})")
        out[name] = {"loss_diff": abs(l_gpu - l_cpu), "grad_rel_l2": rel,
                     "grad_cos": cos, "worst_leaf": worst,
                     "worst_leaf_rel_l2": per_leaf[worst]}
    return out


def train_step_times(torch, seed: int, smi: str,
                     preset: str = "eyepacs_binary", timed: int = 10
                     ) -> dict:
    """Per step form: train step time (host clock around a synchronized
    step; median of ``timed`` after 3 warm), images/s, and the device's busy
    time per step (profiler, 1 step), whose complement is its idle
    share."""
    from jama16_retina_tpu_torch import models, train_lib
    from jama16_retina_tpu_torch.data import synthetic
    from jama16_retina_tpu_torch.models import init

    images, grades = synthetic.make_dataset(
        TRAIN_BATCH, synthetic.SynthConfig(image_size=299), seed=seed + 7)
    batch = {"image": torch.from_numpy(images).cuda(),
             "grade": torch.from_numpy(grades).cuda()}
    out = {}
    for form in TRAIN_FORMS:
        cfg = train_config(form, 1000, seed, preset)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = train_lib.create_state(
            cfg, init.init_flax_default(models.build(cfg.model), seed), "cuda")

        def step(i):
            train_lib.train_step(state, batch, cfg)

        times = []
        for i in range(3 + timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(i)
            torch.cuda.synchronize()
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(times)
        busy = device_ms(step, 1, strict=False)
        peak = torch.cuda.max_memory_allocated()
        out[form] = {"step_ms": med, "min_ms": min(times),
                     "max_ms": max(times), "busy_ms": busy,
                     "images_per_s": TRAIN_BATCH / med * 1e3,
                     "idle": 1 - busy / med, "peak": peak, "state": state,
                     "cfg": cfg, "batch": batch}
        log(f"times: train step {preset} {form} batch {TRAIN_BATCH} bf16: "
            f"median {med:.3f} ms (min {min(times):.3f}, max "
            f"{max(times):.3f}), {TRAIN_BATCH / med * 1e3:.1f} images/s; "
            f"device busy {busy:.3f} ms, idle "
            f"{100 * (1 - busy / med):.1f} %; peak device memory {peak} "
            f"bytes ({smi})")
        if preset != "eyepacs_binary":
            # Only eyepacs_binary's states are profiled (``--profile``).
            del out[form]["state"], state, step
            torch.cuda.empty_cache()
    return out


def profile_train(torch, steps: dict, out_dir: str) -> None:
    """Device time by operator and kernel for one train step of each
    form, written to ``<out_dir>/profile_train_<form>.txt``."""
    from torch.profiler import ProfilerActivity, profile

    from jama16_retina_tpu_torch import train_lib

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for form, t in steps.items():
        train_lib.train_step(t["state"], t["batch"], t["cfg"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            train_lib.train_step(t["state"], t["batch"], t["cfg"])
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=30)
        (out / f"profile_train_{form}.txt").write_text(table)
        log(f"profile: train step {form}, top kernels by device time:")
        log("\n".join(table.splitlines()[:24]))


def profile_request(torch, serve: dict, out_dir: str) -> None:
    """Device time by operator and kernel for one bf16 k=2 batch-64
    request, written to ``<out_dir>/profile_bf16_k2_b64.txt``."""
    from torch.profiler import ProfilerActivity, profile
    import numpy as np

    cfg, engine = serve["engines"]["bfloat16"]
    imgs = np.resize(serve["canvases"], (64,) + serve["canvases"].shape[1:])
    engine.probs(imgs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.probs(imgs)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=25)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_bf16_k2_b64.txt").write_text(table)
    log("profile: bf16 k=2 batch=64 request, top kernels by device time:")
    log("\n".join(table.splitlines()[:20]))


def fit_config(steps: int, workdir: Path, seed: int, *extra):
    from jama16_retina_tpu_torch import configs

    return configs.override(configs.get_config("eyepacs_binary"), [
        f"train.steps={steps}", f"train.eval_every={FIT_EVAL_EVERY}",
        "train.log_every=1", f"train.seed={seed}",
        f"train.checkpoint_dir={workdir}", f"data.batch_size={TRAIN_BATCH}",
        *extra])


def fit_run(torch, cfg, data: Path) -> "tuple[dict, dict, list]":
    """One ``trainer.fit`` on the card, launch counts set to 0 just before
    and read just after -> (result, counts, metrics records)."""
    from jama16_retina_tpu_torch import trainer
    from jama16_retina_tpu_torch.utils.logging import read_jsonl

    workdir = cfg.train.checkpoint_dir
    torch.cuda.synchronize()
    reset_launch_counts()
    result = trainer.fit(cfg, str(data), workdir, device="cuda")
    counts = launch_counts()
    return result, counts, read_jsonl(f"{workdir}/{trainer.METRICS_FILE}")


def read_back(paths) -> "tuple[int, float, float]":
    """(bytes, seconds to read and decode every record, seconds of the
    CRC-32C over the same bytes alone)."""
    from jama16_retina_tpu_torch.data import tfrecord

    t0 = time.perf_counter()
    records = [d for p in paths for d in tfrecord.read_records(p)]
    for d in records:
        tfrecord.parse_record(d)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for d in records:
        tfrecord.crc32c(d)
    return sum(len(d) for d in records), read_s, time.perf_counter() - t0


def read_probs_csv(path: Path) -> "tuple[list, np.ndarray, np.ndarray]":
    """(names, grades, probabilities) of a ``save_probs`` CSV."""
    import csv

    import numpy as np

    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return ([r["name"] for r in rows],
            np.array([int(r["grade"]) for r in rows]),
            np.array([float(r["prob_referable"]) for r in rows]))


def reports_gap(a: dict, b: dict, p, y, dev: float) -> "str | None":
    """None when two evaluation reports of one split agree as far as
    probabilities that differ by ``dev`` (read at 6 decimals) allow, else
    what differs. ``p``, ``y``: one device's probabilities and labels.
    Two images can change order only where they lie within ``tie`` of each
    other, and an image can change side of a threshold only within ``tie``
    (plus the threshold's own shift) of it: the AUC may differ by the
    share of positive/negative pairs that can change order (so not at all
    where none can), a sensitivity (specificity) by the share of positives
    (negatives) that can move. Thresholds agree within 1e-4."""
    import numpy as np

    tie = 2 * dev + 3e-6  # both devices' shift and the CSV's rounding
    pos, neg = p[y == 1], p[y == 0]
    near_pairs = int(np.sum(np.abs(pos[:, None] - neg[None, :]) <= tie))
    if abs(a["auc"] - b["auc"]) > near_pairs / max(pos.size * neg.size, 1):
        return (f"AUC {a['auc']} vs {b['auc']} with {near_pairs} "
                "positive/negative pairs within reach of each other")
    near = np.sum(np.abs(p[:, None] - p[None, :]) <= tie, axis=1) > 1
    for key in ("operating_points", "operating_points_transferred"):
        for ra, rb in zip(a[key], b[key], strict=True):
            # A threshold above every probability is inf on both.
            shift = (0.0 if ra["threshold"] == rb["threshold"]
                     else abs(ra["threshold"] - rb["threshold"]))
            moved = near | (np.abs(p - rb["threshold"]) <= shift + tie)
            if (shift > 1e-4 or abs(ra["sensitivity"] - rb["sensitivity"])
                    > np.sum(moved & (y == 1)) / max(pos.size, 1)
                    or abs(ra["specificity"] - rb["specificity"])
                    > np.sum(moved & (y == 0)) / max(neg.size, 1)):
                return f"{key}: {ra} vs {rb}"
    return None


def phase_fit(torch, seed: int, smi: str, step_ms: float) -> dict:
    """Train from TFRecord splits, validate, checkpoint, resume and
    evaluate, at full width on the card (phase 6 of the docstring)."""
    import numpy as np

    from jama16_retina_tpu_torch import models, train_lib
    from jama16_retina_tpu_torch.data import tfrecord
    from jama16_retina_tpu_torch.models import init
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

    t_phase = time.perf_counter()
    root = SCRATCH / "fit"
    shutil.rmtree(root, ignore_errors=True)
    data = root / "data"
    t0 = time.perf_counter()
    for split, n, shards, split_seed in FIT_SPLITS:
        tfrecord.write_synthetic_split(str(data), split, n, 299,
                                       num_shards=shards, seed=split_seed,
                                       encoding="raw")
    log(f"fit: wrote raw splits {[(s, n, k) for s, n, k, _ in FIT_SPLITS]} "
        f"(split, images, shards) at 299 px in "
        f"{time.perf_counter() - t0:.2f} s")
    val_paths = tfrecord.list_split(str(data), "val")
    n_bytes, read_s, crc_s = read_back(val_paths)
    log(f"fit: read val back: {n_bytes} bytes of records in {read_s:.4f} s "
        f"= {n_bytes / read_s / 1e6:.1f} MB/s (CRC-32C alone "
        f"{n_bytes / crc_s / 1e6:.1f} MB/s, host CPU; {smi})")

    # Run A: 8 steps, evals at 4 and 8.
    cfg_a = fit_config(FIT_STEPS, root / "a", seed)
    res_a, counts_a, recs_a = fit_run(torch, cfg_a, data)
    log(f"fit: run A: {res_a}; launches {counts_a}")
    check(counts_a["fused_color_jitter"] == FIT_STEPS
          and counts_a["fused_normalize_color_jitter"] == 0
          and counts_a["fused_adamw_update"] == 0,
          f"run A launched {counts_a}, want B1 = {FIT_STEPS}, B2 = B3 = 0")
    check(set(res_a) == {"best_auc", "best_step", "stopped_early"},
          f"fit returned keys {sorted(res_a)}")
    evals_a = [r for r in recs_a if r["kind"] == "eval"]
    check([r["step"] for r in evals_a] == [4, 8],
          f"run A evals at {[r['step'] for r in evals_a]}, want [4, 8]")
    check(all(np.isfinite(r["val_auc"]) and 0 <= r["val_auc"] <= 1
              for r in evals_a), f"run A val AUCs {evals_a}")
    ck_a = ckpt_lib.Checkpointer(str(root / "a"))
    check((root / "a" / "best").is_dir() and (root / "a" / "latest").is_dir()
          and ck_a.latest_step == FIT_STEPS,
          f"run A: best/ latest/ and latest step {ck_a.latest_step}")
    train_a = {r["step"]: r for r in recs_a if r["kind"] == "train"}
    losses_a = {s: r["loss"] for s, r in train_a.items()}
    check(all(np.isfinite(list(losses_a.values()))),
          f"run A losses {losses_a}")
    stream_ms = statistics.median(
        1e3 * r["window_sec"] for s, r in train_a.items()
        if s > 1 and r["pause_sec"] == 0 and r["save_sec"] == 0)
    input_ms = statistics.median(
        1e3 * r["input_wait_sec"] for s, r in train_a.items() if s > 1)
    after_eval = train_a[FIT_EVAL_EVERY + 1]
    save_bytes = (root / "a" / "latest" / str(FIT_STEPS) /
                  ckpt_lib.STATE_FILE).stat().st_size
    log(f"times: fit run A: step over the TFRecord stream, prefetched "
        f"(data.prefetch_batches={cfg_a.data.prefetch_batches}, data."
        f"readers={cfg_a.data.readers}), median {stream_ms:.3f} ms (input "
        f"wait {input_ms:.3f} ms) vs {step_ms:.3f} ms in memory (preset); "
        f"read on the step's thread before the prefetch (PERF.md): 210.9 ms "
        f"(input wait 51.5 ms) vs 174.0 ms; val eval of "
        f"{FIT_SPLITS[1][1]} images "
        f"{1e3 * after_eval['pause_sec']:.1f} ms; checkpoint save "
        f"{1e3 * after_eval['save_sec']:.1f} ms, {save_bytes} bytes "
        f"written to latest/ and linked into best/ ({smi})")

    # Run B: 4 steps, then resume to 8.
    cfg_b = fit_config(4, root / "b", seed)
    _, counts_b1, _ = fit_run(torch, cfg_b, data)
    check(counts_b1["fused_color_jitter"] == 4,
          f"run B's first call launched {counts_b1}, want B1 = 4")
    saved = ckpt_lib.Checkpointer(str(root / "b")).restore(4)
    cfg_b2 = fit_config(FIT_STEPS, root / "b", seed, "train.resume=true")
    state = train_lib.create_state(cfg_b2, init.init_flax_default(
        models.build(cfg_b2.model), seed + 1), "cuda")
    again = train_lib.state_to_flat(train_lib.load_state_flat(state, saved))
    check(set(again) == set(saved) and all(
        np.array_equal(again[k], saved[k]) for k in saved),
        "the state restored on the card differs from the one saved at 4")
    del state
    res_b, counts_b, recs_b = fit_run(torch, cfg_b2, data)
    log(f"fit: run B resumed: {res_b}; launches {counts_b}; the state "
        f"saved at step 4 restored bitwise ({len(saved)} arrays)")
    check([r["step"] for r in recs_b if r["kind"] == "resume"] == [4],
          "run B has no resume record at step 4")
    check(counts_b["fused_color_jitter"] == FIT_STEPS - 4,
          f"run B's resume launched {counts_b}, want B1 = 4")
    losses_b = {r["step"]: r["loss"] for r in recs_b if r["kind"] == "train"}
    diff = max(abs(losses_a[s] - losses_b[s]) for s in range(5, 9))
    log(f"fit: run B vs run A losses at steps 5-8: max |diff| {diff:.3e} "
        "(not asserted: run B's first call ran a 4-step schedule)")

    # Evaluate run A's best step on test, thresholds from val, float32,
    # on each device; the probabilities it wrote and its reports compared.
    dev_cpu = evaluate_card_and_cpu(cfg_a, data, root / "a", root, "fit")
    icdr5 = phase_fit_icdr5(torch, seed, data, root, smi)
    wall = time.perf_counter() - t_phase
    log(f"times: fit phase wall {wall:.1f} s ({smi})")
    return {"launches": {"run_a": counts_a, "run_b_first": counts_b1,
                         "run_b_resume": counts_b,
                         "icdr5": icdr5["launches"]},
            "stream_step_ms": stream_ms, "memory_step_ms": step_ms,
            "val_read_mb_s": n_bytes / read_s / 1e6,
            "crc_mb_s": n_bytes / crc_s / 1e6,
            "eval_ms": 1e3 * after_eval["pause_sec"],
            "save_ms": 1e3 * after_eval["save_sec"],
            "save_bytes": save_bytes, "resume_loss_diff": diff,
            "eval_card_vs_cpu": dev_cpu, "wall_s": wall,
            "input_wait_ms": input_ms, "root": root, "data": data}


def phase_fit_icdr5(torch, seed: int, data: Path, root: Path,
                    smi: str) -> dict:
    """The 5-class head's fit and evaluate path on the fit phase's splits
    (``icdr5``: Inception-v3, 299 px, batch 32, bf16, label smoothing
    0.1, its preset step with no kernel): ``ICDR5_STEPS`` steps of
    ``trainer.fit`` with one eval, then ``evaluate_checkpoints`` of the
    best step on ``test`` with thresholds from ``val``, float32 with TF32
    off, on the card and on the CPU, each writing its ``save_probs``
    CSV. The card's probabilities (every CSV column) within 1e-4 of the
    CPU's; the report has ``accuracy`` and ``quadratic_weighted_kappa``;
    the CSV has the ``prob_grade_*`` columns."""
    import csv

    import numpy as np

    from jama16_retina_tpu_torch import configs, trainer

    t0 = time.perf_counter()
    workdir = root / "icdr5"
    cfg = configs.override(configs.get_config("icdr5"), [
        f"train.steps={ICDR5_STEPS}", f"train.eval_every={ICDR5_STEPS}",
        "train.log_every=1", f"train.seed={seed}",
        f"train.checkpoint_dir={workdir}", f"data.batch_size={TRAIN_BATCH}"])
    res, counts, recs = fit_run(torch, cfg, data)
    evals = [r for r in recs if r["kind"] == "eval"]
    log(f"fit icdr5: {res}; launches {counts}; eval records {evals}")
    check(sum(counts.values()) == 0,
          f"the icdr5 preset step launched {counts}, want no kernel")
    check([r["step"] for r in evals] == [ICDR5_STEPS]
          and all(np.isfinite(r["val_auc"]) and 0 <= r["val_auc"] <= 1
                  for r in evals), f"icdr5 evals {evals}")
    losses = [r["loss"] for r in recs if r["kind"] == "train"]
    check(len(losses) == ICDR5_STEPS and bool(np.all(np.isfinite(losses))),
          f"icdr5 losses {losses}")
    cfg_eval = configs.override(cfg, ["model.compute_dtype=float32"])
    reports, cols = {}, {}
    for dev in ("cuda", "cpu"):
        path = root / f"icdr5_probs_{dev}.csv"
        reports[dev] = trainer.evaluate_checkpoints(
            cfg_eval, str(data), [str(workdir)], split="test",
            threshold_split="val", save_probs=str(path), device=dev)
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        cols[dev] = {k: [r[k] for r in rows] for k in rows[0]}
    report = reports["cuda"]
    log(f"fit icdr5: evaluate cuda: accuracy {report['accuracy']}, "
        f"quadratic weighted kappa {report['quadratic_weighted_kappa']}, "
        f"AUC of P(grade >= 2) {report['auc']:.6f}")
    want_cols = ["name", "grade", "quality", "prob_referable",
                 *[f"prob_grade_{c}" for c in range(5)]]
    check(list(cols["cuda"]) == list(cols["cpu"]) == want_cols,
          f"icdr5 save_probs columns {list(cols['cuda'])}")
    check(all({"accuracy", "quadratic_weighted_kappa"} <= set(r)
              for r in reports.values()), "icdr5 report lacks its metrics")
    check(cols["cuda"]["name"] == cols["cpu"]["name"]
          and cols["cuda"]["grade"] == cols["cpu"]["grade"],
          "icdr5 evaluations saw other images")
    dev_cpu = max(float(np.max(np.abs(np.array(cols["cuda"][k], float)
                                      - np.array(cols["cpu"][k], float))))
                  for k in want_cols[3:])
    log(f"fit icdr5: evaluate float32 card vs CPU max |prob diff| "
        f"{dev_cpu:.3e} over {len(cols['cpu']['name'])} test images and "
        f"{len(want_cols) - 3} CSV columns (6 decimals; atol 1e-4, TF32 "
        f"off); {time.perf_counter() - t0:.1f} s ({smi})")
    check(dev_cpu <= 1e-4, f"icdr5 card and CPU disagree by {dev_cpu}")
    return {"launches": counts, "eval_card_vs_cpu": dev_cpu}


def timed_steps(torch, state, batch, cfg, warm: int = 2,
                timed: int = KNOB_STEPS) -> "tuple[float, float, float]":
    """(median, min, max) ms of ``timed`` synchronized train steps after
    ``warm``, host clock."""
    from jama16_retina_tpu_torch import train_lib

    times = []
    for i in range(warm + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_lib.train_step(state, batch, cfg)
        torch.cuda.synchronize()
        if i >= warm:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times), max(times)


def phase_knobs(torch, seed: int, smi: str, fit: dict) -> dict:
    """The trainer's run knobs at full width (phase 9 of the docstring):
    bf16 master weights, accumulation, async saves with overlapped evals
    on the fit phase's splits, and the warm start from its ``best/``."""
    import numpy as np

    from jama16_retina_tpu_torch import configs, models, train_lib, trainer
    from jama16_retina_tpu_torch.data import augment, synthetic
    from jama16_retina_tpu_torch.eval import metrics
    from jama16_retina_tpu_torch.models import convert, init
    from jama16_retina_tpu_torch.serve.engine import ServingEngine
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

    t_phase = time.perf_counter()
    root, data = fit["root"], fit["data"]
    out = {"launches": {}}
    images, grades = synthetic.make_dataset(
        TRAIN_BATCH, synthetic.SynthConfig(image_size=299), seed=seed + 7)
    batch = {"image": torch.from_numpy(images).cuda(),
             "grade": torch.from_numpy(grades).cuda()}
    fused = train_config("fused", 1000, seed)
    base = init.init_flax_default(models.build(fused.model), seed)
    per_step = b3_launches_per_call(len(list(base.parameters())))

    def state_for(cfg):
        model = models.build(cfg.model)
        model.load_state_dict(base.state_dict())
        return train_lib.create_state(cfg, model, "cuda")

    def want_counts(steps):
        return {"fused_color_jitter": 0, "fused_normalize_color_jitter": steps,
                "fused_adamw_update": steps * per_step,
                "fused_serve_preprocess": 0}

    # The train stream in turns: unprefetched, prefetched from one reader
    # process (the default), prefetched from two.
    streams = {}
    for turn, (depth, readers) in enumerate(STREAM_TURNS):
        cfg = fit_config(STREAM_STEPS, root / f"stream{turn}", seed,
                         f"data.prefetch_batches={depth}",
                         f"data.readers={readers}",
                         f"train.eval_every={STREAM_STEPS}")
        _, counts, recs = fit_run(torch, cfg, data)
        check(counts["fused_color_jitter"] == STREAM_STEPS,
              f"the stream run launched {counts}")
        train = {r["step"]: r for r in recs if r["kind"] == "train"}
        steady = range(3, STREAM_STEPS)
        step = statistics.median(1e3 * train[s]["window_sec"] for s in steady)
        wait = statistics.median(1e3 * train[s]["input_wait_sec"]
                                 for s in steady)
        streams.setdefault(f"depth {depth}, readers {readers}", []).append(
            (step, wait))
        out["launches"][f"fit_stream{turn}"] = counts
        log(f"times: knobs stream data.prefetch_batches={depth} data.readers="
            f"{readers}: step median {step:.3f} ms, input wait {wait:.3f} ms "
            f"(steps 3-{STREAM_STEPS - 1}) ({smi})")
    for mode, runs in streams.items():
        log(f"knobs: stream {mode}: step medians "
            f"{[round(a, 3) for a, _ in runs]} ms, input waits "
            f"{[round(b, 3) for _, b in runs]} ms, in turns ({smi})")
    out["streams"] = streams

    # bf16 master weights: one fused step per dtype from one init on one
    # batch (the same draws), then the step's time and peak memory.
    losses, times = {}, {}
    for dtype in ("fp32", "bf16"):
        cfg = configs.override(fused, [f"train.dtype={dtype}"])
        state = state_for(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # The main path: counts set to 0 just before, read just after.
        reset_launch_counts()
        losses[dtype] = float(train_lib.train_step(state, batch, cfg))
        med, lo, hi = timed_steps(torch, state, batch, cfg)
        counts = launch_counts()
        times[dtype] = (med, lo, hi, torch.cuda.max_memory_allocated())
        check(counts == want_counts(1 + 2 + KNOB_STEPS),
              f"the {dtype} fused steps launched {counts}")
        out["launches"][f"knobs_{dtype}"] = counts
        leaves = [*state.model.parameters(), *state.mu.values(),
                  *state.nu.values()]
        check(all(t.dtype == torch.float32 for t in leaves),
              f"a {dtype} master or moment left float32")
        del state
    diff = abs(losses["bf16"] - losses["fp32"])
    log(f"knobs: bf16 masters: after {3 + KNOB_STEPS} fused steps every "
        f"master and moment is float32; first-step loss {losses['bf16']:.6f}"
        f" vs {losses['fp32']:.6f} with float32 params (|diff| {diff:.3e}, "
        "limit 0.05)")
    check(diff < 0.05, f"bf16 loss {diff} away from the float32 step's")
    check(losses["bf16"] != losses["fp32"],
          "train.dtype=bf16 left the loss exactly the float32 step's")
    for dtype, (med, lo, hi, peak) in times.items():
        log(f"times: knobs fused step train.dtype={dtype} batch "
            f"{TRAIN_BATCH}: median {med:.3f} ms (min {lo:.3f}, max "
            f"{hi:.3f}), {TRAIN_BATCH / med * 1e3:.1f} images/s; peak device "
            f"memory {peak} bytes ({smi})")
    out["bf16"] = {"loss_diff": diff, "times": times}

    # Accumulation: the gradient of one batch of 8 images tiled 4 times
    # (the augment draws tiled with them, dropout 0, float32, TF32 off),
    # whole and in 2 and 4 micro-batches.
    f32 = configs.override(fused, ["model.compute_dtype=float32",
                                   "model.dropout_rate=0.0"])
    drawn = augment._draw_params(
        torch.Generator(device="cuda").manual_seed(seed + 11), 8, f32.data,
        "cuda")
    tile = {k: v.repeat(4, *([1] * (v.ndim - 1))) for k, v in drawn.items()}
    tiled = {k: v[:8].repeat(4, *([1] * (v.ndim - 1)))
             for k, v in batch.items()}
    grads = {}
    for accum in ACCUM:
        cfg = configs.override(f32, [f"train.accum_steps={accum}"])
        state = state_for(cfg)
        loss, g = train_lib.compute_grads(state, tiled, cfg,
                                          augment_params=tile)
        grads[accum] = (float(loss), torch.cat(
            [x.detach().double().reshape(-1) for x in g]))
        del state, g
    loss1, g1 = grads[1]
    out["accum"] = {}
    for accum in ACCUM[1:]:
        loss_a, ga = grads[accum]
        rel = float((ga - g1).norm() / g1.norm())
        cos = float(ga @ g1 / (ga.norm() * g1.norm()))
        log(f"knobs: accumulation {accum} x {TRAIN_BATCH // accum} vs 1 x "
            f"{TRAIN_BATCH} on a tiled batch (float32, TF32 off): loss "
            f"|diff| {abs(loss_a - loss1):.3e} (limit 1e-4); gradient "
            f"relative L2 {rel:.3e} (limit 0.08), cosine {cos:.9f} (limit "
            "0.995)")
        check(abs(loss_a - loss1) <= 1e-4 and rel <= 0.08 and cos >= 0.995,
              f"the gradient accumulated over {accum} micro-batches differs "
              "from the whole batch's")
        out["accum"][accum] = {"loss_diff": abs(loss_a - loss1),
                               "grad_rel_l2": rel, "grad_cos": cos}
    del grads, g1
    # Accumulation on 8 distinct images: accum 2 against the two halves'
    # gradients at accum 1, each halved and summed in order, the second
    # half's after the first half's BatchNorm update (as the micro-batches
    # run). cuDNN's deterministic algorithms here: its default weight
    # gradients are not repeatable, and the float32 Inception-v3 gradient
    # turns that into 1.4e-4 relative L2 (H100 80GB HBM3, 700 W). Keeping
    # one micro-batch, or one micro-batch's BN moments for both, is far
    # outside this bar.
    two = configs.override(f32, ["train.accum_steps=2"])
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        state = state_for(two)
        loss2, g2 = train_lib.compute_grads(
            state, {k: v[:8] for k, v in batch.items()}, two,
            augment_params={k: v[:8] for k, v in drawn.items()})
        g2 = torch.cat([x.detach().double().reshape(-1) for x in g2])
        state = state_for(f32)
        halves, acc = [], None
        for rows in (slice(0, 4), slice(4, 8)):
            loss_h, g = train_lib.compute_grads(
                state, {k: v[rows] for k, v in batch.items()}, f32,
                augment_params={k: v[rows] for k, v in drawn.items()})
            halves.append(float(loss_h))
            # As the port accumulates: float32, acc + g * (1 / 2).
            part = torch.cat([x.detach().reshape(-1) for x in g]) * 0.5
            acc = part if acc is None else acc + part
        del state, g
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    acc = acc.double()
    rel = float((g2 - acc).norm() / acc.norm())
    loss_diff = abs(float(loss2) - sum(halves) / 2)
    log(f"knobs: accumulation 2 x 4 on 8 distinct images vs the halves' "
        f"gradients at accum 1 (float32, TF32 off, cuDNN deterministic): "
        f"loss |diff| {loss_diff:.3e} (limit 1e-6); gradient relative L2 "
        f"{rel:.3e} (limit 1e-6)")
    check(loss_diff <= 1e-6 and rel <= 1e-6,
          "accum 2 differs from its micro-batches' gradients in order")
    out["accum"]["halves"] = {"loss_diff": loss_diff, "grad_rel_l2": rel}
    del g2, acc
    for accum in ACCUM:
        cfg = configs.override(fused, [f"train.accum_steps={accum}"])
        state = state_for(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        med, lo, hi = timed_steps(torch, state, batch, cfg)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check(counts == want_counts(2 + KNOB_STEPS),
              f"accum {accum}: {2 + KNOB_STEPS} steps launched {counts}, "
              "want B2 and B3 once a step")
        out["launches"][f"knobs_accum{accum}"] = counts
        log(f"times: knobs fused step train.accum_steps={accum} batch "
            f"{TRAIN_BATCH}: median {med:.3f} ms (min {lo:.3f}, max "
            f"{hi:.3f}); peak device memory {peak} bytes; launches {counts} "
            f"({smi})")
        del state

    # Async saves, then async saves with overlapped evals, on the fit
    # phase's splits; each saved step re-scored from its checkpoint.
    for name, extra in (("async", ["train.async_save=true"]),
                        ("overlap", ["train.async_save=true",
                                     "train.eval_overlap=true"])):
        cfg = fit_config(FIT_STEPS, root / name, seed, *extra)
        res, counts, recs = fit_run(torch, cfg, data)
        out["launches"][f"fit_{name}"] = counts
        check(counts["fused_color_jitter"] == FIT_STEPS,
              f"the {name} fit launched {counts}, want B1 = {FIT_STEPS}")
        aucs = {r["step"]: r["val_auc"] for r in recs if r["kind"] == "eval"}
        check(sorted(aucs) == [FIT_EVAL_EVERY, FIT_STEPS],
              f"the {name} fit's evals {aucs}")
        train = {r["step"]: r for r in recs if r["kind"] == "train"}
        after = train[FIT_EVAL_EVERY + 1]
        windows = [round(1e3 * train[s]["window_sec"], 1)
                   for s in range(FIT_EVAL_EVERY + 1, FIT_STEPS + 1)]
        log(f"times: fit {name} ({', '.join(extra)}): save stall "
            f"{1e3 * after['save_sec']:.1f} ms (sync save before these knobs, "
            f"PERF.md: 928.7 ms), eval pause {1e3 * after['pause_sec']:.1f} ms "
            f"(sync eval then: 297.1 ms); steps {FIT_EVAL_EVERY + 1}-{FIT_STEPS} took "
            f"{windows} ms, the first one with the pause and the save; "
            f"result {res}; launches {counts} ({smi})")
        ck = ckpt_lib.Checkpointer(str(root / name))
        check(ck.latest_step == FIT_STEPS and ck.all_steps() == set(aucs),
              f"the {name} fit saved {sorted(ck.all_steps())}")
        for step in sorted(ck.all_steps()):
            member = convert.flax_to_torch(
                ckpt_lib.eval_tree(ck.restore(step)), models.build(cfg.model))
            engine = ServingEngine(cfg, state_dicts=[member], device="cuda")
            g, p, _ = trainer.predict_split(cfg, engine.member_probs,
                                            str(data), "val")
            auc = metrics.roc_auc((g >= 2).astype(np.float64), p[0])
            check(auc == aucs[step],
                  f"{name} step {step}: recorded val AUC {aucs[step]} but "
                  f"its checkpoint scores {auc}")
        log(f"knobs: fit {name}: every saved step {sorted(aucs)} re-scored "
            f"from its checkpoint equals its recorded val AUC "
            f"{[aucs[s] for s in sorted(aucs)]}")
        out[name] = {"save_ms": 1e3 * after["save_sec"],
                     "pause_ms": 1e3 * after["pause_sec"],
                     "windows_ms": windows}

    # Warm start from run A's best/.
    donor = str(root / "a")
    cfg = fit_config(2, root / "warm", seed + 1, f"train.init_from={donor}",
                     "train.eval_every=2")
    state = train_lib.create_state(cfg, init.init_flax_default(
        models.build(cfg.model), seed + 1), "cuda")
    trainer._warm_start_state(cfg, state, donor)
    got = train_lib.state_to_flat(state)
    want = ckpt_lib.Checkpointer(donor).restore()
    keys = [k for k in want if k.startswith(("params/", "batch_stats/"))]
    check(all(np.array_equal(got[k], want[k]) for k in keys)
          and state.step == 0 and int(state.count) == 0,
          "the warm-started step-0 state is not the donor's best step")
    del state
    res, counts, recs = fit_run(torch, cfg, data)
    out["launches"]["fit_warm"] = counts
    check([r["init_from"] for r in recs if r["kind"] == "warm_start"]
          == [donor] and counts["fused_color_jitter"] == 2,
          f"the warm-started fit: {res}, launches {counts}")
    log(f"knobs: warm start from run A's best step: {len(keys)} params and "
        f"batch statistics equal the donor's at step 0; a 2-step fit from "
        f"it: {res}, launches {counts}")
    wall = time.perf_counter() - t_phase
    log(f"times: knobs phase wall {wall:.1f} s ({smi})")
    out["wall_s"] = wall
    return out


def request_ms(torch, fn, warm: int = 2,
               timed: int = 10) -> "tuple[float, float, float]":
    """(median, min, max) ms of ``timed`` synchronized ``fn()`` calls after
    ``warm``, host clock."""
    times = []
    for i in range(warm + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warm:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times), max(times)


def fmt_ms(t) -> str:
    return f"median {t[0]:.3f} ms, range {t[1]:.3f}-{t[2]:.3f}"


def batcher_storm(b, table, picks, threads: int, burst: bool = False
                  ) -> dict:
    """``len(picks)`` requests (rows = canvas indices) from ``threads``
    client threads through the micro-batcher ``b``, each client
    submitting its next request when its last resolved (closed loop), or
    all at once with ``burst``; ``b`` is closed after. Returns the
    per-request latencies (ms) of the served ones, the outcome counts and
    the rows that disagree with ``table`` (the engine's score of each
    canvas at the one bucket)."""
    import threading

    import numpy as np

    from jama16_retina_tpu_torch.serve import batcher as batcher_lib

    canvases = table["canvases"]
    lat, outcome, wrong = [], {"served": 0, "shed": 0, "deadline": 0}, []
    t_start = time.perf_counter()
    lock = threading.Lock()

    def settle(idx, fut, t0):
        try:
            got = fut.result(timeout=120)
        except batcher_lib.DeadlineExceeded:
            with lock:
                outcome["deadline"] += 1
            return
        ms = (time.perf_counter() - t0) * 1e3
        bad = np.flatnonzero(got != table["probs"][idx])
        with lock:
            lat.append((ms, (t0 - t_start) * 1e3))
            outcome["served"] += 1
            wrong.extend(idx[bad].tolist())

    def client(mine):
        pending = []
        for idx in mine:
            t0 = time.perf_counter()
            try:
                fut = b.submit(canvases[idx])
            except batcher_lib.Overloaded:
                with lock:
                    outcome["shed"] += 1
                continue
            if burst:
                pending.append((idx, fut, t0))
            else:
                settle(idx, fut, t0)
        for item in pending:
            settle(*item)

    workers = [threading.Thread(target=client, args=(picks[t::threads],))
               for t in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(300)
    check(not any(w.is_alive() for w in workers), "a batcher client hung")
    b.close()
    return {"lat": sorted(lat), "outcome": outcome, "wrong": wrong}


def default_path_turns(torch, base, sds, batches, eng, out: dict,
                       smi: str) -> int:
    """The fp32 engine ``eng`` against one ``nn.Module`` per member built
    from the same state_dicts, driving the request path the engine had
    before its serving knobs (pad, B4, members in turn, stats): scores
    within 1e-6, then each form's request latency at batch 8 and 64 in
    alternating turns. Returns the B4 launches made."""
    import numpy as np

    from jama16_retina_tpu_torch import models
    from jama16_retina_tpu_torch.eval import metrics
    from jama16_retina_tpu_torch.ops import serve_preprocess as sp

    modules = []
    for sd in sds:
        m = models.build(base.model)
        m.load_state_dict(sd)
        modules.append(m.to(eng.device, memory_format=torch.channels_last))
    size, head = base.model.image_size, base.model.head
    launched = [0]

    def module_probs(images):
        outs, sums = [], []
        with torch.inference_mode():
            for lo in range(0, images.shape[0], eng.max_batch):
                chunk = images[lo:lo + eng.max_batch]
                n = chunk.shape[0]
                padded = torch.zeros((eng._bucket_for(n), size, size, 3),
                                     dtype=torch.uint8, device=eng.device)
                padded[:n].copy_(torch.from_numpy(np.ascontiguousarray(chunk)))
                norm, chunk_sums = sp.fused_serve_preprocess(padded)
                launched[0] += 1
                sums.append(chunk_sums[:n])
                x = norm.permute(0, 3, 1, 2)
                outs.append(torch.stack([
                    models.head_probs(m(x)[0], head)[:n] for m in modules]))
            probs = torch.cat(outs, dim=1).cpu().numpy()
            sp.input_stats_dict(sp.stats_from_sums(torch.cat(sums).cpu(),
                                                   size * size))
        return metrics.ensemble_average(list(probs))

    dev = float(np.max(np.abs(module_probs(batches[64])
                              - eng.probs(batches[64]))))
    check(dev <= 1e-6, f"the fp32 engine is {dev} from one module per "
          "member")
    forms = {"modules": module_probs, "engine": eng.probs}
    turns = {f"{form}_batch{b}_ms": [] for form in forms for b in batches}
    for order in (("modules", "engine"), ("engine", "modules")) * 5:
        for form in order:
            for b, imgs in batches.items():
                turns[f"{form}_batch{b}_ms"].append(
                    request_ms(torch, lambda: forms[form](imgs))[0])
    launched[0] += eng.chunks_dispatched
    wins = {b: sum(e < m for e, m in zip(turns[f"engine_batch{b}_ms"],
                                         turns[f"modules_batch{b}_ms"]))
            for b in batches}
    out["default_path"] = {"max_dev": dev, "engine_wins": wins, **turns}
    log(f"serve knobs: default path (fp32, members in turn): engine vs one "
        f"module per member, max |score diff| {dev:.3e}; request median ms "
        f"in 10 alternating pairs, batch 8: engine "
        f"{turns['engine_batch8_ms']}, modules {turns['modules_batch8_ms']}, "
        f"engine faster in {wins[8]} of 10; batch 64: engine "
        f"{turns['engine_batch64_ms']}, modules "
        f"{turns['modules_batch64_ms']}, engine faster in {wins[64]} of 10 "
        f"({smi})")
    return launched[0]


def phase_serve_knobs(torch, seed: int, smi: str, serve: dict) -> dict:
    """The serving knobs at full width (phase 10 of the docstring) on
    phase 4's k=2 ``eyepacs_binary`` members."""
    import numpy as np

    from jama16_retina_tpu_torch import configs, models
    from jama16_retina_tpu_torch.models import convert
    from jama16_retina_tpu_torch.obs import quality
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.ops import serve_preprocess as sp
    from jama16_retina_tpu_torch.serve.engine import ServingEngine
    from jama16_retina_tpu_torch.serve.quantize import DtypeRejected
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

    t_phase = time.perf_counter()
    base = configs.override(configs.get_config("eyepacs_binary"),
                            ["serve.fused_preprocess=true"])
    sds = [convert.flax_to_torch(ckpt_lib.load_member(d),
                                 models.build(base.model))
           for d in serve["dirs"]]
    canvases = render(seed + 500, 64)
    batches = {b: canvases[:b] for b in (8, 64)}

    def engine(*sets, **kw):
        return ServingEngine(configs.override(base, list(sets)),
                             state_dicts=sds, device="cuda",
                             registry=kw.get("registry", Registry()))

    # The main path of the phase: counts set to 0 just before, read just
    # after; every request below goes through B4 once a chunk.
    reset_launch_counts()
    chunks = 0
    out = {"dtypes": {}}
    scores = {}
    for dtype in ("fp32", "bf16", "int8"):
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        eng = engine(f"serve.dtype={dtype}")
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated() - mem0
        scores[dtype] = eng.probs(batches[64])
        check(bool(np.all(np.isfinite(scores[dtype]))),
              f"serve.dtype={dtype} probabilities not finite")
        rec = {"resident_bytes": eng.resident_bytes(),
               "allocated_bytes": allocated,
               "max_dev_fp32": float(np.max(np.abs(scores[dtype]
                                                   - scores["fp32"])))}
        for b, imgs in batches.items():
            rec[f"batch{b}_ms"] = request_ms(torch, lambda: eng.probs(imgs))
        chunks += eng.chunks_dispatched
        out["dtypes"][dtype] = rec
        log(f"serve knobs: serve.dtype={dtype}: members resident "
            f"{rec['resident_bytes']} bytes (allocated "
            f"{rec['allocated_bytes']}); max |score - fp32| "
            f"{rec['max_dev_fp32']:.3e} over 64 canvases; request batch 8 "
            f"{fmt_ms(rec['batch8_ms'])}; batch 64 "
            f"{fmt_ms(rec['batch64_ms'])} ({smi})")
        del eng
    res = {d: r["resident_bytes"] for d, r in out["dtypes"].items()}
    check(res["bf16"] < 0.55 * res["fp32"] and res["int8"] < 0.55 * res["bf16"],
          f"resident bytes do not shrink with the dtype: {res}")

    # The default path (fp32, members in turn) against the form it had
    # before the serving knobs: one nn.Module per member on the card, the
    # same request path by hand. Turns alternate, batch 8 and 64.
    chunks += default_path_turns(torch, base, sds, batches, engine(), out,
                                 smi)

    # The construction gate, on a canary pinned from the fp32 scores.
    canary = quality.save_canary(str(SCRATCH / "canary"), canvases[:8],
                                 scores["fp32"][:8])
    gate = ("obs.quality.enabled=true", f"obs.quality.canary_path={canary}")
    for dtype in ("bf16", "int8"):
        passed = engine(f"serve.dtype={dtype}", *gate)
        check(passed.quality.canary.reference is not None,
              "the canary was not pinned")
        chunks += passed.chunks_dispatched
        del passed
        try:
            refused = engine(f"serve.dtype={dtype}", *gate,
                             "serve.dtype_canary_max_dev=0")
            chunks += refused.chunks_dispatched
            check(False, f"serve.dtype={dtype} passed the gate at max_dev 0")
        except DtypeRejected as e:
            chunks += 1  # the refused gate scored the canary, one chunk
            log(f"serve knobs: gate {dtype}: passes at the default 0.05, "
                f"refused at 0 ({str(e).split(';')[0]})")
    chunks += engine("serve.dtype=fp32", *gate,
                     "serve.dtype_canary_max_dev=0").chunks_dispatched

    # member_parallel: agreement in float32 (TF32 off), latency at the
    # preset's bf16 compute.
    f32 = "model.compute_dtype=float32"
    pair = {form: engine(f32, f"serve.member_parallel={form == 'vmap'}")
            for form in ("in_turn", "vmap")}
    mp = {form: e.member_probs(batches[64]) for form, e in pair.items()}
    chunks += sum(e.chunks_dispatched for e in pair.values())
    del pair
    mp_dev = float(np.max(np.abs(mp["vmap"] - mp["in_turn"])))
    check(mp_dev <= 1e-4, f"member_parallel and members in turn disagree by "
          f"{mp_dev} (float32, TF32 off)")
    out["member_parallel"] = {"max_dev": mp_dev}
    for form in ("in_turn", "vmap"):
        eng = engine(f"serve.member_parallel={form == 'vmap'}")
        for b, imgs in batches.items():
            out["member_parallel"][f"{form}_batch{b}_ms"] = request_ms(
                torch, lambda: eng.probs(imgs))
        chunks += eng.chunks_dispatched
        del eng
    m = out["member_parallel"]
    log(f"serve knobs: member_parallel vs members in turn: max |member prob "
        f"diff| {mp_dev:.3e} (float32, TF32 off); bf16 compute, batch 8: "
        f"vmap {fmt_ms(m['vmap_batch8_ms'])}, in turn "
        f"{fmt_ms(m['in_turn_batch8_ms'])}; batch 64: vmap "
        f"{fmt_ms(m['vmap_batch64_ms'])}, in turn "
        f"{fmt_ms(m['in_turn_batch64_ms'])} ({smi})")

    # The micro-batcher: one bucket of 32, so every row runs at the shape
    # the table was scored at; 4 closed-loop clients, then a burst.
    reg = Registry()
    one_bucket = ("serve.max_batch=32", "serve.bucket_sizes=32")
    eng = engine(*one_bucket, registry=reg)
    table = {"canvases": canvases, "probs": eng.probs(canvases)}
    rng = np.random.default_rng(seed)
    picks = [rng.integers(0, 64, int(n)) for n in rng.integers(1, 9, 200)]
    storm = batcher_storm(eng.make_batcher(), table, picks, threads=4)
    lat = np.asarray([ms for ms, _ in storm["lat"]])
    slowest = ", ".join(f"{ms:.1f} ms at {at:.0f} ms"
                        for ms, at in storm["lat"][-3:])
    hist = reg.snapshot()["histograms"]["serve.request_latency_s"]
    check(storm["outcome"]["served"] == 200,
          f"the batcher served {storm['outcome']}")
    check(not storm["wrong"], f"{len(storm['wrong'])} batcher rows differ "
          "from the engine's score at the same bucket")
    counters = reg.snapshot()["counters"]
    out["batcher"] = {
        "requests": 200, "rows": int(sum(len(p) for p in picks)),
        "windows": counters["serve.batcher.batches"],
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "hist_p50_ms": hist["p50"] * 1e3, "hist_p99_ms": hist["p99"] * 1e3}
    bt = out["batcher"]
    log(f"serve knobs: batcher, 4 closed-loop clients, 200 requests of 1-8 "
        f"rows ({bt['rows']} rows) in {bt['windows']:.0f} windows, every row "
        f"equal to the engine's score at bucket 32; request latency p50 "
        f"{bt['p50_ms']:.3f} ms, p99 {bt['p99_ms']:.3f} ms (histogram "
        f"estimate {bt['hist_p50_ms']:.3f} / {bt['hist_p99_ms']:.3f}); the "
        f"slowest three, with their submit times into the run: {slowest} "
        f"({smi})")
    chunks += eng.chunks_dispatched
    del eng
    reg = Registry()
    eng = engine(*one_bucket, "serve.shed_queue_depth=8",
                 "serve.default_deadline_ms=5", registry=reg)
    burst = batcher_storm(eng.make_batcher(), table, picks, threads=4,
                          burst=True)
    counters = reg.snapshot()["counters"]
    shed = {k: counters.get(k, 0.0)
            for k in ("serve.shed.queue_depth", "serve.shed.deadline")}
    o = burst["outcome"]
    check(o["shed"] == shed["serve.shed.queue_depth"] > 0
          and o["deadline"] == shed["serve.shed.deadline"] > 0
          and sum(o.values()) == 200 and not burst["wrong"],
          f"forced overload: outcomes {o}, counters {shed}, "
          f"{len(burst['wrong'])} rows wrong")
    out["overload"] = {**o, **shed}
    log(f"serve knobs: forced overload (burst of 200, shed_queue_depth 8, "
        f"deadline 5 ms): served {o['served']}, shed {o['shed']} "
        f"(serve.shed.queue_depth {shed['serve.shed.queue_depth']:.0f}), "
        f"deadline {o['deadline']} (serve.shed.deadline "
        f"{shed['serve.shed.deadline']:.0f}); served rows equal the table")
    chunks += eng.chunks_dispatched
    del eng

    # The monitor fed by B4's statistics, against a profile of the same
    # canvases from the host numpy pass.
    host_stats = quality.input_stat_values(canvases)
    profile = quality.save_profile(
        str(SCRATCH / "profile.json"),
        quality.build_profile(scores["fp32"], stat_values=host_stats))
    reg = Registry()
    eng = engine("obs.quality.enabled=true",
                 f"obs.quality.profile_path={profile}",
                 "obs.quality.window_scores=64", registry=reg)
    eng.probs(canvases)
    b4 = eng.last_input_stats
    diffs = {k: int(np.abs(quality.bin_counts(b4[k], 20)
                           - quality.bin_counts(host_stats[k], 20)).sum())
             for k in quality.INPUT_STATS}
    stat_dev = max(float(np.max(np.abs(b4[k] - host_stats[k])))
                   for k in quality.INPUT_STATS)
    # The host pass sums in float32 (input_stat_values, as the reference
    # does); B4's integer sums are exact, so they are held to float64.
    x = canvases.astype(np.float64) / 255.0
    chan = x.mean(axis=(1, 2))
    exact = {"mean_r": chan[:, 0], "mean_g": chan[:, 1],
             "mean_b": chan[:, 2],
             "std": x.reshape(x.shape[0], -1).std(axis=1),
             "brightness": chan @ np.array([0.299, 0.587, 0.114])}
    exact_dev = max(float(np.max(np.abs(b4[k] - exact[k])))
                    for k in quality.INPUT_STATS)
    snap = reg.snapshot()
    check(snap["counters"]["quality.scores"] == 64
          and snap["counters"]["quality.windows"] == 1,
          f"the monitor saw {snap['counters']}")
    check(exact_dev <= 1e-9, f"B4's statistics are {exact_dev} from a "
          "float64 pass")
    chunks += eng.chunks_dispatched
    del eng
    out["monitor"] = {"bin_count_diffs": diffs, "max_stat_dev": stat_dev,
                      "max_stat_dev_float64": exact_dev,
                      "input_psi_max": snap["gauges"]["quality.input_psi_max"],
                      "score_psi": snap["gauges"]["quality.score_psi"]}
    log(f"serve knobs: monitor fed by B4: 64 scores in 1 window; |count "
        f"differences| of B4's histograms (20 bins) against the host numpy "
        f"pass {diffs}; max |stat diff| {stat_dev:.3e} from it (float32 "
        f"sums), {exact_dev:.3e} from a float64 pass; input_psi_max "
        f"{out['monitor']['input_psi_max']:.4g}, score_psi "
        f"{out['monitor']['score_psi']:.4g} against that pass's profile")

    counts = launch_counts()
    check(counts["fused_serve_preprocess"] == chunks > 0,
          f"B4 launched {counts['fused_serve_preprocess']} times for "
          f"{chunks} chunks")
    check(sum(counts.values()) == chunks,
          f"the serve-knobs path launched a train kernel: {counts}")
    out["launches"] = counts
    log(f"serve knobs: launches {counts} for {chunks} chunks; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s ({smi})")
    return out


# Phase 11: the optimizer families at full width, the large-batch recipe
# fits, and member-parallel ensemble10.
OPT_FAMILIES = {"sgdm": ["train.optimizer=sgdm"],
                "rmsprop": ["train.optimizer=rmsprop"],
                "lamb": ["train.optimizer=lamb"],
                "adamw+clip": ["train.gradient_clip_norm=1.0"]}
OPT_STEPS = 3
# Card-vs-CPU update bound per leaf (relative L2): LAMB's norms reduce in
# another order on the card.
OPT_BOUND = {"lamb": 1e-5}
OPT_BOUND_DEFAULT = 1e-6
RECIPE_REF_BATCH = 8
ENSEMBLE_K = 2
# Tried in turn when a k runs out of device memory.
ENSEMBLE_KS = (ENSEMBLE_K,)
ENSEMBLE_STEPS = 4
ENSEMBLE_EVAL_EVERY = 2
AGREE_BATCH = 8
RATIO_TURNS = ("stacked", "sequential")
RATIO_STEPS = 2


def phase_optimizers(torch, seed: int, smi: str) -> dict:
    """Phase 11a: each optimizer family (and adamw behind the clip) on
    ``eyepacs_binary`` at full width from one seeded init: 4 steps (B1
    once a step, counted), finite losses, step time, launches and peak
    memory; then one update on the same float32 gradients and state on
    the card and on the CPU, held per leaf."""
    import numpy as np

    from jama16_retina_tpu_torch import configs, models, optim, train_lib
    from jama16_retina_tpu_torch.data import synthetic
    from jama16_retina_tpu_torch.models import init

    images, grades = synthetic.make_dataset(
        TRAIN_BATCH, synthetic.SynthConfig(image_size=299), seed=seed + 11)
    batch = {"image": torch.from_numpy(images).cuda(),
             "grade": torch.from_numpy(grades).cuda()}
    base = init.init_flax_default(
        models.build(configs.get_config("eyepacs_binary").model), seed)
    out = {"launches": {}, "families": {}}
    for fam, items in OPT_FAMILIES.items():
        family = fam.split("+")[0]
        cfg = configs.override(configs.get_config("eyepacs_binary"), [
            "train.steps=1000", f"train.seed={seed}",
            f"data.batch_size={TRAIN_BATCH}", *items])
        model = models.build(cfg.model)
        model.load_state_dict(base.state_dict())
        state = train_lib.create_state(cfg, model, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # The main path: counts set to 0 just before, read just after.
        reset_launch_counts()
        losses, times = [], []
        for _ in range(OPT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(train_lib.train_step(state, batch, cfg)))
            times.append((time.perf_counter() - t0) * 1e3)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check(counts == {"fused_color_jitter": OPT_STEPS,
                         "fused_normalize_color_jitter": 0,
                         "fused_adamw_update": 0,
                         "fused_serve_preprocess": 0},
              f"the {fam} steps launched {counts}")
        check(bool(np.all(np.isfinite(losses))),
              f"{fam} losses not finite: {losses}")
        out["launches"][f"optim_{fam}"] = counts
        step_ops = sum(n for _, n in device_ops(
            torch, lambda: train_lib.train_step(state, batch, cfg),
            warm=False))
        # One update on the same float32 gradients and state, card and CPU.
        _, grads = train_lib.compute_grads(state, batch, cfg)
        names = [k for k, _ in state.model.named_parameters()]
        params = dict(state.model.named_parameters())
        moms = train_lib.moments(state)
        sides = {}
        for dev in ("cuda", "cpu"):
            p = [params[k].detach().to(dev, copy=True) for k in names]
            m = {n: [moms[n][k].to(dev, copy=True) for k in names]
                 for n in moms}
            g = [t.to(dev, copy=True) for t in grads]
            count = (None if state.count is None
                     else state.count.to(dev, copy=True))

            def update(p=p, g=g, m=m, count=count, dev=dev):
                optim.apply_update(family, cfg.train, p, g, m, count,
                                   state.sched_count.to(dev),
                                   train_lib.make_schedule(cfg.train))

            if dev == "cuda":
                update_ops = sum(n for _, n in device_ops(torch, update,
                                                          warm=False))
            else:
                update()
            sides[dev] = p + [t for n in sorted(m) for t in m[n]]
        worst = 0.0
        for a, b in zip(sides["cuda"], sides["cpu"]):
            a64, b64 = a.cpu().double(), b.double()
            rel = float((a64 - b64).norm() / max(float(b64.norm()), 1e-30))
            worst = max(worst, rel)
        bound = OPT_BOUND.get(family, OPT_BOUND_DEFAULT)
        check(worst <= bound, f"{fam}: the card's update is {worst:.3g} "
              f"(relative L2, worst leaf) from the CPU's, bound {bound}")
        med = statistics.median(times[1:])
        out["families"][fam] = {
            "step_ms": med, "step_ms_range": [min(times[1:]), max(times[1:])],
            "launches_per_step": step_ops, "update_launches": update_ops,
            "peak_bytes": peak, "card_vs_cpu": worst, "bound": bound,
            "losses": losses}
        log(f"optim: {fam}: losses {[round(x, 5) for x in losses]}; step "
            f"median {med:.3f} ms (steps 2-{OPT_STEPS}, range "
            f"{min(times[1:]):.3f}-{max(times[1:]):.3f}), "
            f"{TRAIN_BATCH * 1e3 / med:.1f} images/s; {step_ops} device "
            f"launches a step, {update_ops} in the update over "
            f"{len(names)} leaves; peak device memory {peak} bytes; card vs "
            f"CPU update {worst:.3g} relative L2 (worst of "
            f"{len(sides['cpu'])} leaves, bound {bound}) ({smi})")
        del state, sides, grads
        torch.cuda.empty_cache()
    return out


def phase_recipe(torch, seed: int, smi: str, root: Path, data: Path) -> dict:
    """Phase 11b: a 4-step ``lamb`` fit with ``lr_scale_ref_batch=8`` on
    the fit phase's splits (its effective learning rate, logged, must be
    4x ``learning_rate``), rerun against its own curve as
    ``recipe_curve_ref`` (passes), then against that curve shifted by 0.5
    (stops with ``RecipeCurveRejected``)."""
    import logging

    from jama16_retina_tpu_torch import train_lib
    from jama16_retina_tpu_torch.utils.logging import read_jsonl

    class Grab(logging.Handler):
        def __init__(self):
            super().__init__(logging.INFO)
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    # cuDNN deterministic: the gated rerun must see the first run's curve.
    flags = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    grab = Grab()
    lib_log = logging.getLogger(train_lib.__name__)
    level = lib_log.level
    lib_log.addHandler(grab)
    lib_log.setLevel(logging.INFO)
    out = {"launches": {}}
    items = ["train.optimizer=lamb",
             f"train.lr_scale_ref_batch={RECIPE_REF_BATCH}",
             "train.lr_schedule=warmup_cosine", "train.warmup_steps=1",
             f"train.eval_every={ENSEMBLE_EVAL_EVERY}"]
    try:
        cfg = fit_config(ENSEMBLE_STEPS, root / "recipe_a", seed, *items)
        _, counts, recs = fit_run(torch, cfg, data)
    finally:
        lib_log.removeHandler(grab)
        lib_log.setLevel(level)
    out["launches"]["recipe_fit"] = counts
    check(counts["fused_color_jitter"] == ENSEMBLE_STEPS,
          f"the recipe fit launched {counts}")
    lines = [s for s in grab.lines if s.startswith("large-batch recipe")]
    check(len(lines) == 1, f"the recipe logged {grab.lines}")
    eff = float(re.search(r"-> (\S+) \(lamb\)", lines[0]).group(1))
    want = cfg.train.learning_rate * TRAIN_BATCH / RECIPE_REF_BATCH
    check(abs(eff - want) <= 1e-6 * want and TRAIN_BATCH
          == 4 * RECIPE_REF_BATCH,
          f"effective LR {eff} != {want} (4x {cfg.train.learning_rate})")
    curve = {r["step"]: r["val_auc"] for r in recs if r["kind"] == "eval"}
    ref = root / "recipe_a" / "metrics.jsonl"
    again_cfg = fit_config(ENSEMBLE_STEPS, root / "recipe_b", seed, *items,
                           f"train.recipe_curve_ref={ref}")
    _, counts, again = fit_run(torch, again_cfg, data)
    out["launches"]["recipe_gated"] = counts
    again_curve = {r["step"]: r["val_auc"] for r in again
                   if r["kind"] == "eval"}
    check(sorted(again_curve) == sorted(curve),
          f"the gated rerun evaluated {sorted(again_curve)}")
    shifted = root / "recipe_shifted.jsonl"
    with open(shifted, "w") as f:
        for step, auc in curve.items():
            f.write(json.dumps({"kind": "eval", "step": step,
                                "val_auc": auc - 0.5}) + "\n")
    refused = None
    try:
        fit_run(torch, fit_config(ENSEMBLE_STEPS, root / "recipe_c", seed,
                                  *items,
                                  f"train.recipe_curve_ref={shifted}"), data)
    except train_lib.RecipeCurveRejected as e:
        refused = str(e)
    check(refused is not None and f"step {ENSEMBLE_EVAL_EVERY}" in refused,
          f"the shifted curve was not refused at step "
          f"{ENSEMBLE_EVAL_EVERY}: {refused}")
    done = [r for r in read_jsonl(root / "recipe_c" / "metrics.jsonl")
            if r["kind"] == "eval"]
    log(f"recipe: lamb, batch {TRAIN_BATCH}, lr_scale_ref_batch="
        f"{RECIPE_REF_BATCH}: logged \"{lines[0]}\"; effective LR {eff:g} = "
        f"4 x {cfg.train.learning_rate:g}; val AUC {curve}; the rerun gated "
        f"on that curve (tol {cfg.train.recipe_curve_tol}) passed with "
        f"{again_curve}; the curve shifted by -0.5 refused after "
        f"{len(done)} eval: {refused} ({smi})")
    for name in ("recipe_a", "recipe_b", "recipe_c"):
        shutil.rmtree(root / name, ignore_errors=True)
    torch.backends.cudnn.deterministic = flags
    return out


def ensemble_config(k: int, steps: int, workdir: Path, seed: int, *extra):
    """``ensemble10`` cut to ``k`` members and ``steps`` steps, stacked,
    with ``data.use_pallas`` (B1) and a constant learning rate (so a run
    cut at step 2 and resumed is the uninterrupted run)."""
    from jama16_retina_tpu_torch import configs

    return configs.override(configs.get_config("ensemble10"), [
        f"train.ensemble_size={k}", "train.ensemble_parallel=true",
        "train.ensemble_parallel_force=true", "data.use_pallas=true",
        "train.lr_schedule=constant", f"train.steps={steps}",
        f"train.eval_every={ENSEMBLE_EVAL_EVERY}", "train.log_every=1",
        f"train.seed={seed}", f"train.checkpoint_dir={workdir}",
        f"data.batch_size={TRAIN_BATCH}", *extra])


def ensemble_fit(torch, cfg, data: Path) -> "tuple[list, dict, list, int]":
    """``trainer.fit_ensemble`` (stacked), counts set to 0 just before and
    read just after -> (result, counts, metrics records, peak bytes)."""
    from jama16_retina_tpu_torch import trainer
    from jama16_retina_tpu_torch.utils.logging import read_jsonl

    workdir = cfg.train.checkpoint_dir
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    result = trainer.fit_ensemble(cfg, str(data), workdir, device="cuda")
    counts = launch_counts()
    return (result, counts,
            read_jsonl(f"{workdir}/{trainer.METRICS_FILE}"),
            torch.cuda.max_memory_allocated())


def phase_ensemble(torch, seed: int, smi: str, root: Path, data: Path
                   ) -> dict:
    """Phase 11c: member-parallel ``ensemble10`` on the fit phase's
    splits: B1 at the stacked shape against its plain version; the
    stacked fit (the largest k of ``ENSEMBLE_KS`` that fits, each
    out-of-memory error recorded); layout, a resume from step 2 bitwise
    the uninterrupted run; the stacked step against the members in turn;
    and the stacked step timed against k member steps in turns."""
    import gc

    import numpy as np

    from jama16_retina_tpu_torch import configs, models, train_lib
    from jama16_retina_tpu_torch.data import synthetic
    from jama16_retina_tpu_torch.models import init
    from jama16_retina_tpu_torch.ops import color_jitter as cj
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

    out = {"launches": {}, "oom": []}
    dev = torch.device("cuda")
    t_fits = time.perf_counter()
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        free, total = torch.cuda.mem_get_info()
        log(f"ensemble: device memory before the phase: {free} of {total} "
            f"bytes free ({smi})")
        k = None
        for k_try in ENSEMBLE_KS:
            gen = torch.Generator(device=dev).manual_seed(seed + 3)
            imgs, b1_args, _ = jitter_inputs(
                torch, dev, (k_try * TRAIN_BATCH, 299, 299, 3), gen)
            got = cj.fused_color_jitter(imgs, *b1_args)
            want = cj.color_jitter_reference(imgs, *b1_args)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"fused_color_jitter differs at "
                  f"the stacked shape [{k_try * TRAIN_BATCH}, 299, 299, 3]")
            log(f"kernels: fused_color_jitter [{k_try * TRAIN_BATCH}, 299, "
                "299, 3] (the stacked step's one launch) bitwise")
            del imgs, b1_args, got, want
            full = root / f"ens{k_try}_full"
            try:
                res, counts, recs, peak = ensemble_fit(
                    torch, ensemble_config(k_try, ENSEMBLE_STEPS, full, seed),
                    data)
                k = k_try
                break
            except torch.cuda.OutOfMemoryError as e:
                msg = str(e).splitlines()[0]
                free, total = torch.cuda.mem_get_info()
                out["oom"].append({"k": k_try, "error": msg})
                log(f"ensemble: k={k_try} ran out of device memory: {msg} "
                    f"(after cleanup {free} of {total} bytes free)")
                del e
                gc.collect()
                torch.cuda.empty_cache()
                shutil.rmtree(full, ignore_errors=True)
        check(k is not None, f"no k of {ENSEMBLE_KS} fits: {out['oom']}")
        out["k"] = k
        out["launches"]["ensemble_fit"] = counts
        check(counts == {"fused_color_jitter": ENSEMBLE_STEPS,
                         "fused_normalize_color_jitter": 0,
                         "fused_adamw_update": 0,
                         "fused_serve_preprocess": 0},
              f"the stacked fit launched {counts}, want B1 once a step")
        for m in range(k):
            mdir = Path(ckpt_lib.member_dir(str(full), m))
            check(sorted(p.name for p in (mdir / "latest").iterdir())
                  == [str(ENSEMBLE_STEPS)] and any((mdir / "best").iterdir()),
                  f"member {m} lacks best/ or latest/{ENSEMBLE_STEPS}")
            with open(mdir / "run_meta.json") as f:
                check(json.load(f)["seed"] == seed + m,
                      f"member {m} run_meta seed")
        evals = [r for r in recs if r["kind"] == "eval"]
        check([r["step"] for r in evals] == [2, 4]
              and all(len(r["val_auc_per_member"]) == k
                      and 0.0 <= r["ensemble_val_auc"] <= 1.0
                      for r in evals), f"stacked eval records {evals}")
        trains = [r for r in recs if r["kind"] == "train"]
        check(all(np.all(np.isfinite(r["loss_per_member"])) for r in trains),
              "a member's loss is not finite")
        out["peak"] = peak
        log(f"ensemble: k={k} stacked fit of {ENSEMBLE_STEPS} steps: "
            f"ensemble val AUC {[r['ensemble_val_auc'] for r in evals]}, "
            f"best steps {[r['best_step'] for r in res]}, launches {counts}, "
            f"peak device memory {peak} bytes ({smi})")

        # Resume from step 2 to 4, bitwise the uninterrupted run.
        cut = root / f"ens{k}_cut"
        _, counts, _, _ = ensemble_fit(
            torch, ensemble_config(k, ENSEMBLE_EVAL_EVERY, cut, seed), data)
        out["launches"]["ensemble_cut"] = counts
        _, counts, recs, _ = ensemble_fit(
            torch, ensemble_config(k, ENSEMBLE_STEPS, cut, seed,
                                   "train.resume=true"), data)
        out["launches"]["ensemble_resume"] = counts
        check(counts["fused_color_jitter"] == ENSEMBLE_STEPS
              - ENSEMBLE_EVAL_EVERY, f"the resumed fit launched {counts}")
        check([r["step"] for r in recs if r["kind"] == "resume"]
              == [ENSEMBLE_EVAL_EVERY], "no resume record at step 2")
        differ = []
        for m in range(k):
            a = ckpt_lib.Checkpointer(ckpt_lib.member_dir(str(full), m))
            b = ckpt_lib.Checkpointer(ckpt_lib.member_dir(str(cut), m))
            x, y = a.restore(ENSEMBLE_STEPS), b.restore(ENSEMBLE_STEPS)
            if set(x) != set(y) or any(not np.array_equal(x[n], y[n])
                                       for n in x):
                differ.append(m)
        check(not differ, f"resumed members {differ} differ from the "
              "uninterrupted run at the last step")
        log(f"times: ensemble fits and resume wall "
            f"{time.perf_counter() - t_fits:.1f} s")
        log(f"ensemble: k={k} cut at step {ENSEMBLE_EVAL_EVERY} and resumed "
            f"to {ENSEMBLE_STEPS}: all {k} members' step-{ENSEMBLE_STEPS} "
            "checkpoints bitwise the uninterrupted run's (cuDNN "
            "deterministic)")
        for path in (full, cut):
            shutil.rmtree(path, ignore_errors=True)

        # The stacked step against the members stepped in turn: float32,
        # TF32 off, sgdm, one step on AGREE_BATCH canvases.
        agree = configs.override(ensemble_config(k, 1000, root, seed), [
            "model.compute_dtype=float32", "train.optimizer=sgdm"])
        canv = render(seed + 21, AGREE_BATCH)
        small = {"image": torch.from_numpy(canv).cuda(),
                 "grade": torch.arange(AGREE_BATCH, device=dev) % 5}
        seeds = [seed + m for m in range(k)]
        state = train_lib.create_ensemble_state(agree, seeds, dev)
        before = {n: p.detach().clone() for n, p in state.params.items()}
        losses = train_lib.ensemble_train_step(state, small, agree)
        stacked = train_lib.eval_state_dicts(state)
        del state
        worst = {"loss": 0.0, "rel": 0.0, "cos": 1.0}
        for m, s in enumerate(seeds):
            mcfg = configs.override(agree, [f"train.seed={s}",
                                             "train.ensemble_size=1"])
            single = train_lib.create_state(
                mcfg, init.init_flax_default(models.build(mcfg.model), s),
                dev)
            loss = float(train_lib.train_step(single, small, mcfg))
            worst["loss"] = max(worst["loss"], abs(loss - float(losses[m])))
            num = den = dot = nrm = 0.0
            for n, p in single.model.named_parameters():
                d_single = (p.detach() - before[n][m]).double()
                d_stack = (stacked[m][n] - before[n][m]).double()
                num += float((d_stack - d_single).square().sum())
                den += float(d_single.square().sum())
                dot += float((d_stack * d_single).sum())
                nrm += float(d_stack.square().sum())
            worst["rel"] = max(worst["rel"], (num / den) ** 0.5)
            worst["cos"] = min(worst["cos"], dot / (nrm * den) ** 0.5)
            del single
        del stacked, before
        torch.cuda.empty_cache()
        check(worst["loss"] <= 1e-3 and worst["rel"] <= 0.08
              and worst["cos"] >= 0.995,
              f"the stacked step vs the members in turn: {worst}")
        out["agreement"] = worst
        log(f"ensemble: k={k} stacked step vs the members in turn (float32, "
            f"TF32 off, sgdm, batch {AGREE_BATCH}, one step): loss within "
            f"{worst['loss']:.3g} (bound 1e-3), worst member's update "
            f"{worst['rel']:.3g} relative L2 (bound 0.08) and cosine "
            f"{worst['cos']:.6f} (bound 0.995)")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            flags)

    log(f"times: ensemble fits, resume and agreement wall "
        f"{time.perf_counter() - t_fits:.1f} s")
    # The card's ratio: the stacked step against k member steps, in turns,
    # preset form (bf16 compute, B1, adamw), batch 32 in memory.
    cfg = ensemble_config(k, 1000, root, seed)
    images, grades = synthetic.make_dataset(
        TRAIN_BATCH, synthetic.SynthConfig(image_size=299), seed=seed + 13)
    batch = {"image": torch.from_numpy(images).cuda(),
             "grade": torch.from_numpy(grades).cuda()}
    seeds = [seed + m for m in range(k)]
    state = train_lib.create_ensemble_state(cfg, seeds, dev)
    singles = []
    for s in seeds:
        mcfg = configs.override(cfg, [f"train.seed={s}",
                                      "train.ensemble_size=1"])
        singles.append((mcfg, train_lib.create_state(
            mcfg, init.init_flax_default(models.build(mcfg.model), s), dev)))
    turns = {"stacked": [], "sequential": []}
    peaks = {"stacked": 0, "sequential": 0}
    for turn in RATIO_TURNS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(1 + RATIO_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if turn == "stacked":
                train_lib.ensemble_train_step(state, batch, cfg)
            else:
                for mcfg, single in singles:
                    train_lib.train_step(single, batch, mcfg)
            torch.cuda.synchronize()
            if i:
                turns[turn].append((time.perf_counter() - t0) * 1e3)
        peaks[turn] = max(peaks[turn], torch.cuda.max_memory_allocated())
    ratio = {}
    for form, times in turns.items():
        med = statistics.median(times)
        ratio[form] = {"step_ms": med, "range": [min(times), max(times)],
                       "member_images_per_sec": k * TRAIN_BATCH * 1e3 / med,
                       "peak_bytes": peaks[form]}
    speedup = ratio["sequential"]["step_ms"] / ratio["stacked"]["step_ms"]
    out["ratio"] = {**ratio, "stacked_speedup": speedup}
    log(f"times: ensemble k={k} (bf16, batch {TRAIN_BATCH}, B1, adamw), in "
        f"turns {list(RATIO_TURNS)}, {RATIO_STEPS} timed steps a turn: "
        f"stacked step {ratio['stacked']['step_ms']:.1f} ms (range "
        f"{ratio['stacked']['range'][0]:.1f}-"
        f"{ratio['stacked']['range'][1]:.1f}), "
        f"{ratio['stacked']['member_images_per_sec']:.1f} member images/s, "
        f"peak {peaks['stacked']} bytes; {k} member steps in turn "
        f"{ratio['sequential']['step_ms']:.1f} ms (range "
        f"{ratio['sequential']['range'][0]:.1f}-"
        f"{ratio['sequential']['range'][1]:.1f}), "
        f"{ratio['sequential']['member_images_per_sec']:.1f} member "
        f"images/s, peak {peaks['sequential']} bytes; stacked speedup "
        f"{speedup:.3f}x ({smi})")
    del state, singles
    torch.cuda.empty_cache()
    return out


# Phase 12: the distilled cascade and serving generations.
CASCADE_K = 2
# Timed calls of each cascade request form.
CASCADE_TIMED = 3
DISTILL_STEPS = 4
DISTILL_EVAL_EVERY = 2
SOFT_CHECK_BATCH = 4
CASCADE_CANVASES = 64
# The band is set to escalate this share of the 64 canvases.
CASCADE_ESCALATE = 0.3
# Speculative vs serial cascade scores (tests/test_torch_cascade.py).
SPEC_TOL = 1e-6
LOAD_BUCKET = 32
LOAD_CLIENTS = 4


def save_random_members(torch, cfg, root: Path, seed: int, k: int) -> list:
    """``k`` seeded random members of ``cfg``'s model as ``params.npz``
    member dirs under ``root``."""
    from jama16_retina_tpu_torch import models
    from jama16_retina_tpu_torch.models import convert
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

    dirs = []
    for m in range(k):
        model = random_member(models.build(cfg.model),
                              torch.Generator().manual_seed(seed + m))
        d = ckpt_lib.member_dir(str(root), m)
        ckpt_lib.save_member(d, convert.torch_to_flax(model))
        dirs.append(d)
    return dirs


def distill_config(steps: int, workdir: Path, seed: int, teacher: Path,
                   *extra):
    """``eyepacs_binary`` distilled from ``teacher``: fused form (B2 + B3),
    bf16 masters, a constant learning rate (so a run cut at step 2 and
    resumed is the uninterrupted run), evals every 2 steps."""
    return fit_config(steps, workdir, seed,
                      f"train.eval_every={DISTILL_EVAL_EVERY}",
                      "train.use_pallas_fused=true", "train.dtype=bf16",
                      "train.lr_schedule=constant",
                      f"train.distill_from={teacher}", *extra)


def phase_distill(torch, seed: int, smi: str, root: Path, data: Path
                  ) -> dict:
    """Phase 12a: ``CASCADE_K`` random teacher members; their float32 soft targets
    on the card against the CPU; a 4-step distill fit on the fit phase's
    splits, and the same fit cut at step 2 and resumed (cuDNN
    deterministic)."""
    import numpy as np

    from jama16_retina_tpu_torch import configs, trainer
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

    base = configs.get_config("eyepacs_binary")
    teacher = root / "teacher"
    t0 = time.perf_counter()
    dirs = save_random_members(torch, base, teacher, seed + 100, CASCADE_K)
    log(f"distill: wrote {CASCADE_K} random teacher members in "
        f"{time.perf_counter() - t0:.1f} s")
    f32 = configs.override(base, ["model.compute_dtype=float32",
                                  f"train.distill_from={teacher}"])
    canv = render(seed + 40, SOFT_CHECK_BATCH)
    card = trainer._distill_teacher(f32, torch.device("cuda"))(
        torch.from_numpy(canv).cuda()).cpu().numpy()
    cpu = trainer._distill_teacher(f32, torch.device("cpu"))(
        torch.from_numpy(canv)).numpy()
    soft_dev = float(np.max(np.abs(card - cpu)))
    check(card.dtype == np.float32 and card.shape == (SOFT_CHECK_BATCH,)
          and np.isfinite(card).all() and soft_dev <= 1e-4,
          f"teacher soft targets card vs CPU: {soft_dev} (bound 1e-4)")
    log(f"distill: k={CASCADE_K} teacher float32 soft targets of "
        f"{SOFT_CHECK_BATCH} canvases, card vs CPU max |diff| "
        f"{soft_dev:.3e} (bound 1e-4, TF32 off); targets "
        f"{np.round(card, 4).tolist()}")
    out = {"launches": {}, "soft_dev": soft_dev, "teacher": dirs}
    want = {"fused_color_jitter": 0, "fused_normalize_color_jitter":
            DISTILL_STEPS, "fused_adamw_update": DISTILL_STEPS,
            "fused_serve_preprocess": 0}
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        full = root / "distill_full"
        t0 = time.perf_counter()
        res, counts, recs = fit_run(
            torch, distill_config(DISTILL_STEPS, full, seed, teacher), data)
        fit_s = time.perf_counter() - t0
        out["launches"]["distill_fit"] = counts
        check(counts == want, f"the distill fit launched {counts}, want "
              f"{want}")
        check([r["distill_from"] for r in recs if r["kind"] == "distill"]
              == [str(teacher)], "no distill record")
        evals = [r for r in recs if r["kind"] == "eval"]
        trains = [r for r in recs if r["kind"] == "train"]
        check([r["step"] for r in evals] == [2, 4]
              and all(np.isfinite(r["loss"]) for r in trains),
              f"distill fit records {evals}")
        log(f"distill: {DISTILL_STEPS}-step fit (bf16, fused, batch "
            f"{TRAIN_BATCH}) from {CASCADE_K} teacher members: losses "
            f"{[round(r['loss'], 4) for r in trains]}, val AUC "
            f"{[r['val_auc'] for r in evals]}, best step {res['best_step']}"
            f", launches {counts}, {fit_s:.1f} s ({smi})")
        cut = root / "distill_cut"
        _, c1, _ = fit_run(torch, distill_config(
            DISTILL_EVAL_EVERY, cut, seed, teacher), data)
        _, c2, recs2 = fit_run(torch, distill_config(
            DISTILL_STEPS, cut, seed, teacher, "train.resume=true"), data)
        out["launches"]["distill_cut"] = c1
        out["launches"]["distill_resume"] = c2
        check(c2["fused_normalize_color_jitter"] == DISTILL_STEPS
              - DISTILL_EVAL_EVERY, f"the resumed distill fit launched {c2}")
        check([r["step"] for r in recs2 if r["kind"] == "resume"]
              == [DISTILL_EVAL_EVERY], "no resume record at step 2")
        a = ckpt_lib.Checkpointer(str(full)).restore(DISTILL_STEPS)
        b = ckpt_lib.Checkpointer(str(cut)).restore(DISTILL_STEPS)
        differ = sorted(k for k in a if k not in b
                        or not np.array_equal(a[k], b[k]))
        check(set(a) == set(b) and not differ,
              f"resumed distill fit differs in {differ[:5]}")
        log(f"distill: cut at step {DISTILL_EVAL_EVERY} and resumed to "
            f"{DISTILL_STEPS}: the step-{DISTILL_STEPS} checkpoint ({len(a)} "
            "arrays) bitwise the uninterrupted run's (cuDNN deterministic)")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            flags)
    out["student"] = str(full)
    return out


def phase_cascade(torch, seed: int, smi: str, root: Path,
                  distill: dict) -> dict:
    """Phase 12b-d: the cascade of the distilled student and the
    ``CASCADE_K`` teacher members (float32, fused preprocess); its gate; the
    ensemble's generations under the micro-batcher's load. Launch counts
    are set to 0 before the path and read after it."""
    import gc
    import threading

    import numpy as np

    from jama16_retina_tpu_torch import configs, models
    from jama16_retina_tpu_torch.models import convert
    from jama16_retina_tpu_torch.obs import quality
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.ops import serve_preprocess as sp
    from jama16_retina_tpu_torch.serve import batcher as batcher_lib
    from jama16_retina_tpu_torch.serve import engine as engine_lib
    from jama16_retina_tpu_torch.serve.assemble import EngineSpec, assemble
    from jama16_retina_tpu_torch.serve.cascade import (CascadeEngine,
                                                       CascadeRejected)
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

    cfg = configs.override(configs.get_config("eyepacs_binary"), [
        "model.compute_dtype=float32", "serve.fused_preprocess=true"])
    canv = render(seed + 50, CASCADE_CANVASES)
    grades = np.arange(CASCADE_CANVASES) % 5
    teacher, student_dir = distill["teacher"], distill["student"]
    gen_b = save_random_members(torch, cfg, root / "gen_b", seed + 200,
                                CASCADE_K)
    # B4 at the load bucket, bitwise against its plain version (outside
    # the counted path).
    x = torch.from_numpy(canv[:LOAD_BUCKET]).cuda()
    (n_k, s_k), (n_p, s_p) = (sp.fused_serve_preprocess(x),
                              sp.serve_preprocess_reference(x))
    check(torch.equal(n_k, n_p) and torch.equal(s_k, s_p),
          f"fused_serve_preprocess differs at [{LOAD_BUCKET}, 299, 299, 3]")
    log(f"kernels: fused_serve_preprocess [{LOAD_BUCKET}, 299, 299, 3] (the "
        "generations' bucket) bitwise")
    out: dict = {}
    chunks = 0
    torch.cuda.synchronize()
    reset_launch_counts()

    t_b = time.perf_counter()
    # (b) The cascade.
    student = engine_lib.ServingEngine(cfg, [student_dir], device="cuda",
                                       registry=Registry())
    ensemble = engine_lib.ServingEngine(cfg, teacher, device="cuda",
                                        registry=Registry())
    s = student.probs(canv)
    thr = float(np.median(s))
    band = float(np.quantile(np.abs(s - thr), CASCADE_ESCALATE))
    ccfg = configs.override(cfg, [f"serve.cascade_band={band!r}",
                                  f"serve.cascade_thresholds={thr!r}"])
    reg = Registry()
    cascade = CascadeEngine(ccfg, student, ensemble, registry=reg)
    got, mask = cascade._probs_masked(canv)
    n_esc = int(mask.sum())
    check(0 < n_esc < CASCADE_CANVASES, f"{n_esc} rows escalated")
    check(np.array_equal(got[~mask], student.probs(canv)[~mask]),
          "a student row differs from student.probs of the request")
    check(np.array_equal(got[mask], ensemble.probs(canv[mask])),
          "an escalated row differs from ensemble.probs(images[mask])")
    check(reg.counter("serve.cascade.student_rows").value == CASCADE_CANVASES
          and reg.counter("serve.cascade.escalated_rows").value == n_esc,
          f"cascade counters {reg.snapshot()}")
    spec_reg = Registry()
    spec = CascadeEngine(configs.override(
        ccfg, ["serve.cascade_speculative=true"]), student, ensemble,
        registry=spec_reg)
    sgot, smask = spec._probs_masked(canv)
    spec_dev = float(np.max(np.abs(sgot - got)))
    check(np.array_equal(smask, mask) and spec_dev <= SPEC_TOL,
          f"speculative vs serial: {spec_dev} (bound {SPEC_TOL})")
    check(spec_reg.counter("serve.cascade.speculated").value
          == CASCADE_CANVASES
          and spec_reg.counter("serve.cascade.speculated.wasted").value
          == CASCADE_CANVASES - n_esc, "speculation counters")
    out.update(escalated=n_esc / CASCADE_CANVASES, spec_dev=spec_dev,
               threshold=thr, band=band, canvases=canv, rows=got,
               spec_rows=sgot, mask=mask)
    log(f"cascade: student = the distill fit's best step, ensemble = the "
        f"{CASCADE_K} teacher members (float32, fused preprocess); threshold"
        f" {thr:.6f} (median student score), band {band:.6f}: {n_esc} of "
        f"{CASCADE_CANVASES} rows escalated "
        f"({100 * n_esc / CASCADE_CANVASES:.1f} %); student rows bitwise student.probs, escalated rows bitwise "
        "ensemble.probs(images[mask]), counters equal the mask's; "
        f"speculative vs serial max |diff| {spec_dev:.3e} (bound {SPEC_TOL})")
    times = {}
    for b in (8, 64):
        xb = canv[:b]
        for name, fn in (("cascade", cascade.probs),
                         ("speculative", spec.probs),
                         ("ensemble", ensemble.probs),
                         ("student", student.probs)):
            times[f"{name}_b{b}"] = request_ms(torch, lambda: fn(xb),
                                               timed=CASCADE_TIMED)
        share = float(cascade.escalation_mask(s[:b]).mean())
        log(f"times: cascade request batch {b} ({100 * share:.0f} % "
            f"escalated): cascade {fmt_ms(times[f'cascade_b{b}'])}; "
            f"speculative {fmt_ms(times[f'speculative_b{b}'])}; ensemble "
            f"alone ({CASCADE_K} members) {fmt_ms(times[f'ensemble_b{b}'])}"
            f"; student alone {fmt_ms(times[f'student_b{b}'])} ({smi})")
    spec.close()
    out["times"] = times

    log(f"times: cascade (b) wall {time.perf_counter() - t_b:.1f} s")
    t_c = time.perf_counter()
    # (c) The gate.
    canary = quality.save_canary(str(root / "canary"), canv[:8],
                                 ensemble.probs(canv[:8]))
    qsets = ["obs.quality.enabled=true", f"obs.quality.canary_path={canary}",
             "obs.quality.canary_every_s=0"]
    faithful = assemble(EngineSpec(
        cfg=configs.override(cfg, qsets + [
            "serve.cascade_band=1.0",
            f"serve.cascade_student_dir={student_dir}"]),
        member_dirs=tuple(teacher), device="cuda", registry=Registry(),
        go_live=True))
    check(isinstance(faithful, CascadeEngine), "assemble built no cascade")
    verdicts = {v.name: v for v in faithful.go_live(canv, grades)}
    check(verdicts["golden_canary"].value == 0.0
          and verdicts["auc_floor"].passed
          and not verdicts["auc_floor"].skipped, f"faithful gate {verdicts}")
    flat = ckpt_lib.load_member(student_dir)
    flat["params/Logits/bias"] = flat["params/Logits/bias"] + 20.0
    garbage = engine_lib.ServingEngine(
        cfg, state_dicts=[convert.flax_to_torch(flat,
                                                models.build(cfg.model))],
        device="cuda", registry=Registry())
    gmin = float(garbage.probs(canv[:8]).min())
    gcfg = configs.override(cfg, qsets + ["serve.cascade_band=0"])
    bad = CascadeEngine(gcfg, garbage, ensemble, registry=Registry(),
                        quality=quality.monitor_from_config(
                            gcfg.obs.quality, registry=Registry()))
    try:
        bad.go_live()
        refused = None
    except CascadeRejected as e:
        refused = str(e)
    check(gmin > 0.99 and refused is not None
          and "golden_canary" in refused,
          f"garbage student (min score {gmin}) not refused: {refused}")
    log(f"cascade gate: band [0, 1] through assemble(go_live=True): "
        f"golden_canary dev {verdicts['golden_canary'].value}, auc_floor "
        f"{verdicts['auc_floor'].value:.6f} >= "
        f"{verdicts['auc_floor'].threshold:.6f}: live; student with head "
        f"bias +20 (min score {gmin:.6f}), band 0: CascadeRejected "
        f"({refused[:160]})")
    engines = [student, ensemble, faithful.student, faithful.ensemble,
               garbage]
    chunks += sum(e.chunks_dispatched for e in engines)
    del cascade, spec, faithful, bad, garbage, student, ensemble, engines
    gc.collect()
    torch.cuda.empty_cache()

    log(f"times: cascade (c) wall {time.perf_counter() - t_c:.1f} s")
    t_d = time.perf_counter()
    # (d) Generations under load.
    lcfg = configs.override(cfg, qsets + [
        "obs.quality.canary_atol=1.0", f"serve.max_batch={LOAD_BUCKET}",
        f"serve.bucket_sizes={LOAD_BUCKET}", "serve.max_wait_ms=2"])
    eng = engine_lib.ServingEngine(lcfg, teacher, device="cuda",
                                   registry=Registry())
    table = {0: eng.probs(canv)}
    one_gen = eng.resident_bytes()
    torch.cuda.synchronize()
    mem = {"before": torch.cuda.memory_allocated()}

    def infer(rows):
        probs, gen = eng.probs_with_generation(rows)
        return np.stack([probs, np.full(len(probs), float(gen))], 1)

    batcher = batcher_lib.MicroBatcher(
        infer, max_batch=LOAD_BUCKET, max_wait_ms=2.0,
        row_shape=(299, 299, 3), row_dtype=np.uint8, registry=Registry())
    stop = threading.Event()
    responses, errors = [], []
    lock = threading.Lock()

    def client(c):
        rng = np.random.default_rng(seed + 300 + c)
        while not stop.is_set():
            idx = rng.integers(0, CASCADE_CANVASES, int(rng.integers(1, 9)))
            try:
                rows = batcher.submit(canv[idx]).result(timeout=120)
                with lock:
                    responses.append((idx, rows))
            except Exception as e:  # noqa: BLE001 - counted and checked
                with lock:
                    errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(LOAD_CLIENTS)]
    for t in threads:
        t.start()
    try:
        time.sleep(1.0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        info = eng.reload(gen_b)
        reload_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        mem["peak_during_reload"] = torch.cuda.max_memory_allocated()
        mem["retained"] = torch.cuda.memory_allocated()
        retained_bytes = eng.resident_bytes()
        probs_b, gen = eng.probs_with_generation(canv)
        table[gen] = probs_b
        time.sleep(1.0)
        t0 = time.perf_counter()
        rb = eng.rollback()
        rollback_ms = (time.perf_counter() - t0) * 1e3
        table[rb["generation"]] = table[0]
        time.sleep(1.0)
    finally:
        stop.set()
        for t in threads:
            t.join(300)
        batcher.close()
    check(not any(t.is_alive() for t in threads), "a load client hung")
    check(not errors, f"{len(errors)} requests failed: {errors[:3]}")
    check(info["generation"] == 1 and info["canary_checked"]
          and rb == {"generation": 2, "restored_from": 0,
                     "n_members": CASCADE_K}, f"reload {info}, rollback {rb}")
    check(retained_bytes == 2 * one_gen, "resident bytes with a generation "
          f"retained {retained_bytes}, one generation {one_gen}")
    seen, worst, exact = {}, 0.0, 0
    for idx, rows in responses:
        g = int(rows[0, 1])
        check(np.all(rows[:, 1] == g) and g in table,
              f"a response spans generations {rows[:, 1]}")
        dev = float(np.max(np.abs(rows[:, 0] - table[g][idx])))
        worst = max(worst, dev)
        exact += dev == 0.0
        seen[g] = seen.get(g, 0) + 1
    check(worst <= 1e-4 and sorted(seen) == [0, 1, 2],
          f"responses by generation {seen}, worst |diff| {worst}")
    # A second rollout, released: back to one generation.
    eng.reload(gen_b)
    eng.release_retained()
    gc.collect()
    torch.cuda.synchronize()
    mem["released"] = torch.cuda.memory_allocated()
    check(eng.resident_bytes() == one_gen, "release_retained kept bytes")
    # A candidate failing the canary: rejected, the live one serves on.
    eng.quality.canary.atol = 1e-6
    live = eng.generation
    try:
        eng.reload(teacher[:1])
        rejected = False
    except engine_lib.ReloadRejected:
        rejected = True
    eng.quality.canary.atol = 1.0
    check(rejected and eng.generation == live
          and eng.registry.counter("serve.reload_rejected").value == 1,
          "a canary-failing candidate went live")
    check(np.array_equal(eng.probs(canv[:8]), table[1][:8]),
          "the live generation changed after a rejected reload")
    # A shadow at fraction 0.25 samples every 4th request.
    eng.begin_shadow(teacher, fraction=0.25)
    for i in range(8):
        eng.probs(canv[i:i + 2])
    report = eng.end_shadow()
    check(report["requests"] == 2 and report["rows"] == 4
          and eng.registry.counter("serve.shadow.requests").value == 2,
          f"shadow report {report}")
    chunks += eng.chunks_dispatched
    counts = launch_counts()
    check(counts["fused_serve_preprocess"] == chunks
          and counts["fused_color_jitter"] == 0
          and counts["fused_normalize_color_jitter"] == 0
          and counts["fused_adamw_update"] == 0,
          f"the cascade path launched {counts}, want B4 once a chunk "
          f"({chunks})")
    out["launches"] = {"cascade_serve": counts}
    out.update(reload_ms=reload_ms, rollback_ms=rollback_ms, memory=mem,
               responses=len(responses), by_generation=seen)
    log(f"generations: {len(responses)} requests of 1-8 rows from "
        f"{LOAD_CLIENTS} closed-loop clients through the micro-batcher "
        f"(bucket {LOAD_BUCKET}), {seen} by generation, 0 failed, every "
        f"row within {worst:.3e} of its generation's direct scoring "
        f"({exact} of {len(responses)} bitwise); reload to {CASCADE_K} "
        f"other members (load, warm-up, canary) {reload_ms:.1f} ms, "
        f"rollback {rollback_ms:.3f} ms ({smi})")
    log(f"times: cascade (d) wall {time.perf_counter() - t_d:.1f} s")
    log(f"generations: memory_allocated before the reload {mem['before']}, "
        f"with a generation retained {mem['retained']} (peak during the "
        f"reload {mem['peak_during_reload']}), after release_retained "
        f"{mem['released']} bytes; one generation {one_gen} bytes; a "
        f"canary-failing candidate raised ReloadRejected (reload_rejected "
        f"1) and generation {live} kept serving; a shadow at 0.25 scored "
        f"{report['requests']} of 8 requests ({report})")
    log(f"cascade: launches {counts} for {chunks} chunks")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


# Phase 13: the router, fusion, policy and scaler.
ROUTER_BUCKETS = (8, 16, 32, 64)
# Seconds of closed-loop load per dispatch policy, and of the failure and
# drain runs; clients 0-2 send interactive requests of 1-8 rows, client 3
# batch requests of 64.
ROUTER_LOAD_S = 1.5
ROUTER_INTERACTIVE, ROUTER_BATCH = 3, 1
ROUTER_BATCH_ROWS = 64
# A fused bin under serve.member_parallel against each tenant's direct
# rows (tests/test_torch_router.py).
FUSED_VMAP_TOL = 1e-5
SCALER_WINDOW_S = 0.5
SCALER_BURST_S = 3.0
# The policy's frontier: seconds per (bucket, concurrency) point.
SWEEP_S = 0.6
SWEEP_CONCURRENCY = (1, 4)


class TaggedReplica:
    """A router replica over a ``ServingEngine`` whose response rows carry
    the bucket their bin ran at, as a second column, so each row can be
    held against the engine's score of its canvas at that bucket. Times
    every bin; from its ``fail_from``-th bin on (when set) it raises, a
    replica that dies."""

    def __init__(self, engine, fail_from: int = 0):
        self.engine = engine
        self.fail_from = fail_from
        self.bins = 0
        self.ms = []

    @property
    def generation(self) -> int:
        return self.engine.generation

    def probs_with_generation(self, rows):
        import numpy as np

        self.bins += 1
        if self.fail_from and self.bins >= self.fail_from:
            raise RuntimeError(f"replica wrapper: bin {self.bins} refused")
        t0 = time.perf_counter()
        out, gen = self.engine.probs_with_generation(rows)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        bucket = next(b for b in self.engine.buckets if b >= len(rows))
        return np.stack([out, np.full(len(out), float(bucket))], 1), gen


def closed_loop(router, canv, seconds: float, seed: int,
                interactive: int = ROUTER_INTERACTIVE,
                batch: int = ROUTER_BATCH, rows: int = 0,
                mid=None) -> list:
    """``interactive`` + ``batch`` closed-loop client threads for
    ``seconds`` (``mid()`` called halfway): interactive requests of 1-8
    random canvases (or ``rows``), batch requests of
    ``ROUTER_BATCH_ROWS``. Returns (class, canvas indices, rows,
    segments, ms, error) per request."""
    import threading

    import numpy as np

    stop = threading.Event()
    lock = threading.Lock()
    recs = []

    def client(c):
        rng = np.random.default_rng(seed + c)
        cls = "interactive" if c < interactive else "batch"
        while not stop.is_set():
            n = ((rows or int(rng.integers(1, 9))) if cls == "interactive"
                 else ROUTER_BATCH_ROWS)
            idx = rng.integers(0, len(canv), n)
            t0 = time.perf_counter()
            try:
                f = router.submit(canv[idx], priority=cls)
                got = np.asarray(f.result(timeout=120))
                rec = (cls, idx, got, f.segments,
                       (time.perf_counter() - t0) * 1e3, None)
            except Exception as e:  # noqa: BLE001 - counted and checked
                rec = (cls, idx, None, None, None, repr(e))
            with lock:
                recs.append(rec)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(interactive + batch)]
    for t in threads:
        t.start()
    try:
        if mid is not None:
            time.sleep(seconds / 2)
            mid()
            time.sleep(seconds / 2)
        else:
            time.sleep(seconds)
    finally:
        stop.set()
        for t in threads:
            t.join(300)
    check(not any(t.is_alive() for t in threads), "a router client hung")
    return recs


def check_routed(recs, tables) -> int:
    """Every request answered, and every row bitwise its replica engine's
    score of that canvas at the bucket its bin ran at (generation 0).
    Returns the number of requests."""
    import numpy as np

    errors = [r[5] for r in recs if r[5] is not None]
    check(not errors, f"{len(errors)} routed requests failed: {errors[:3]}")
    for _cls, idx, rows, segs, _ms, _err in recs:
        check(segs[0]["lo"] == 0 and segs[-1]["hi"] == len(idx)
              and all(a["hi"] == b["lo"] for a, b in zip(segs, segs[1:])),
              f"segments do not tile the request: {segs}")
        for s in segs:
            seg = rows[s["lo"]:s["hi"]]
            b = int(seg[0, 1])
            want = tables[s["replica"]][b][idx[s["lo"]:s["hi"]]]
            check(s["generation"] == 0 and np.all(seg[:, 1] == b)
                  and np.array_equal(seg[:, 0], want),
                  f"routed rows of replica {s['replica']} differ from its "
                  f"engine's at bucket {b}")
    return len(recs)


def nearest_rank(ms, q: float) -> float:
    import numpy as np

    a = np.sort(np.asarray(ms, np.float64))
    return float(a[min(len(a) - 1, max(0, int(np.ceil(q * len(a))) - 1))])


def percentiles(ms) -> str:
    if not ms:
        return "none"
    return (f"n {len(ms)}, p50 {statistics.median(ms):.1f} ms, p99 "
            f"{nearest_rank(ms, 0.99):.1f} ms")


def reset_counts(engines) -> None:
    """Launch counts and the engines' chunk counts set to 0."""
    import torch

    torch.cuda.synchronize()
    reset_launch_counts()
    for e in engines:
        e.chunks_dispatched = 0


def check_b4(part: str, engines, fused_bins: int = 0) -> dict:
    """The part's launch counts: B4 once a chunk the engines dispatched
    (plus once a fused bin), no train kernel."""
    counts = launch_counts()
    chunks = sum(e.chunks_dispatched for e in engines)
    want = {"fused_color_jitter": 0, "fused_normalize_color_jitter": 0,
            "fused_adamw_update": 0,
            "fused_serve_preprocess": chunks + fused_bins}
    check(counts == want and chunks + fused_bins > 0,
          f"router {part}: launches {counts}, want {want}")
    return counts


def router_replicas(torch, seed, smi, cfg, dirs, canv) -> dict:
    """13a: two replicas of the k = 2 engine under each dispatch policy,
    class-aware shedding, a replica's death and a drain."""
    import numpy as np

    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.serve import router as router_lib
    from jama16_retina_tpu_torch.serve.batcher import Overloaded
    from jama16_retina_tpu_torch.serve.engine import ServingEngine

    engines = [ServingEngine(cfg, dirs, device="cuda", registry=Registry())
               for _ in range(2)]
    # Each canvas's score at each bucket, per replica engine (a row's
    # score does not depend on its co-riders at one bucket).
    tables = [{b: np.concatenate([e.probs(canv[i:i + b])
                                  for i in range(0, len(canv), b)])
               for b in ROUTER_BUCKETS} for e in engines]
    out = {"launches": {}}

    def start(policy="least_in_flight", fail_from=0, shed=0):
        rcfg = configs.override(cfg, [f"serve.router_policy={policy}",
                                      f"serve.router_shed_rows={shed}"])
        reps = [TaggedReplica(engines[0]),
                TaggedReplica(engines[1], fail_from=fail_from)]
        reg = Registry()
        return router_lib.Router(rcfg, engines=reps, registry=reg), reps, reg

    for policy in router_lib.DISPATCH_POLICIES:
        reset_counts(engines)
        router, reps, reg = start(policy)
        recs = closed_loop(router, canv, ROUTER_LOAD_S, seed + 10)
        router.close()
        counts = check_b4(policy, engines)
        n = check_routed(recs, tables)
        rep = router.report()
        check(rep["replica_failures"] == 0
              and all(r["rows"] > 0 for r in rep["replicas"]),
              f"{policy}: {rep['replicas']}")
        out["launches"][f"router_{policy}"] = counts
        by_cls = {c: [r[4] for r in recs if r[0] == c]
                  for c in ("interactive", "batch")}
        out[policy] = {c: (statistics.median(v), nearest_rank(v, 0.99),
                           len(v)) for c, v in by_cls.items() if v}
        log(f"router {policy}: {n} requests in {ROUTER_LOAD_S} s from "
            f"{ROUTER_INTERACTIVE} interactive (1-8 rows) and "
            f"{ROUTER_BATCH} batch ({ROUTER_BATCH_ROWS} rows) closed-loop "
            f"clients over 2 replicas (k=2, buckets {list(ROUTER_BUCKETS)}):"
            f" every row bitwise its engine's at its bin's bucket; "
            f"{rep['dispatches']} bins, {rep['rebins']} requests re-binned, "
            f"rows by replica {[r['rows'] for r in rep['replicas']]}; B4 "
            f"{counts['fused_serve_preprocess']} launches, one a chunk; "
            f"interactive {percentiles(by_cls['interactive'])}; batch "
            f"{percentiles(by_cls['batch'])} ({smi})")
        for i, r in enumerate(reps):
            steady = statistics.median(r.ms[1:])
            out.setdefault("first_bin_ms", []).append(
                (policy, i, r.ms[0], steady))
            log(f"router {policy}: replica {i}'s worker thread: first bin "
                f"{r.ms[0]:.1f} ms, steady bins median {steady:.1f} ms of "
                f"{len(r.ms) - 1} ({smi})")

    # The idle share of a routed batch-8 request beside the engine's.
    router, reps, reg = start()
    x8 = canv[:8]
    routed = request_ms(torch, lambda: router.submit(x8).result())
    busy_r = device_ms(lambda i: router.submit(x8).result(), 1,
                       strict=False)
    router.close()
    direct = request_ms(torch, lambda: engines[0].probs(x8))
    busy_d = device_ms(lambda i: engines[0].probs(x8), 1, strict=False)
    out["idle"] = {"routed": routed, "routed_busy": busy_r,
                   "direct": direct, "direct_busy": busy_d}
    log(f"times: batch-8 request (float32, k=2, fused preprocess): routed "
        f"{fmt_ms(routed)}, device busy {busy_r:.3f} ms, idle "
        f"{100 * (1 - busy_r / routed[0]):.1f} %; the engine alone "
        f"{fmt_ms(direct)}, device busy {busy_d:.3f} ms, idle "
        f"{100 * (1 - busy_d / direct[0]):.1f} % ({smi})")

    # Class-aware shedding: batch sheds at half the row threshold, so a
    # burst of interactive and batch submits sheds batch first.
    reset_counts(engines)
    router, reps, reg = start(shed=2 * ROUTER_BATCH_ROWS)
    events, futs = [], []
    rng = np.random.default_rng(seed + 20)
    for _ in range(12):
        for cls, n in (("interactive", 8), ("batch", ROUTER_BATCH_ROWS)):
            idx = rng.integers(0, len(canv), n)
            try:
                futs.append((cls, idx, router.submit(canv[idx],
                                                     priority=cls)))
            except Overloaded:
                events.append(cls)
    recs = [(cls, idx, np.asarray(f.result(timeout=120)), f.segments, None,
             None) for cls, idx, f in futs]
    router.close()
    counts = check_b4("shed", engines)
    check_routed(recs, tables)
    shed = reg.snapshot()["counters"]
    check(events and events[0] == "batch"
          and shed["serve.router.shed.batch"] == events.count("batch")
          and shed["serve.router.shed.interactive"]
          == events.count("interactive"),
          f"shed order {events}, counters {shed}")
    out["launches"]["router_shed"] = counts
    log(f"router shed: serve.router_shed_rows={2 * ROUTER_BATCH_ROWS}, batch "
        f"frac 0.5; a burst of 12 x (interactive 8 rows, batch "
        f"{ROUTER_BATCH_ROWS} rows): shed batch {events.count('batch')}, "
        f"interactive {events.count('interactive')}, the first shed a batch "
        f"request; {len(futs)} admitted, every row bitwise")

    # A replica that raises from its 3rd bin on.
    reset_counts(engines)
    router, reps, reg = start(fail_from=3)
    recs = closed_loop(router, canv, ROUTER_LOAD_S, seed + 30)
    states = router.replica_states()
    router.close()
    counts = check_b4("failure", engines)
    n = check_routed(recs, tables)
    c = reg.snapshot()["counters"]
    check(states[1]["state"] == router_lib.FAILED
          and states[1]["generation"] is None
          and c["serve.router.replica_failures"] == 1
          and c["serve.router.request_failures"] == 0
          and c["serve.router.retried_bins"] >= 1,
          f"replica failure: {states}, {c}")
    out["launches"]["router_failure"] = counts
    log(f"router failure: replica 1 raises from its 3rd bin: marked failed, "
        f"{int(c['serve.router.retried_bins'])} bin(s) retried on replica 0, "
        f"{n} requests, none failed, every row bitwise")

    # Replica 1 drained halfway through the load.
    reset_counts(engines)
    router, reps, reg = start()
    recs = closed_loop(router, canv, ROUTER_LOAD_S, seed + 40,
                       mid=lambda: router.drain_replica(1))
    deadline = time.monotonic() + 30
    while (router.replica_states()[1]["state"] != router_lib.DRAINED
           and time.monotonic() < deadline):
        time.sleep(0.01)
    states = router.replica_states()
    after = router.submit(canv[:8])
    after.result(timeout=120)
    router.close()
    counts = check_b4("drain", engines)
    n = check_routed(recs, tables)
    check(states[1]["state"] == router_lib.DRAINED
          and states[1]["generation"] is None
          and states[1]["in_flight_rows"] == 0
          and all(s["replica"] == 0 for s in after.segments),
          f"drain: {states}")
    out["launches"]["router_drain"] = counts
    log(f"router drain: replica 1 drained halfway through {n} requests "
        f"({states[1]['rows']} rows served before its release), none "
        "failed, later requests on replica 0")
    return out


def router_fusion(torch, seed, smi, cfg, dirs, canv) -> dict:
    """13b: two tenants sharing one bucket of 8, fused, with members in
    turn and under ``serve.member_parallel``."""
    import types

    import numpy as np

    from jama16_retina_tpu_torch import configs, models
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.serve import fusion
    from jama16_retina_tpu_torch.serve import router as router_lib
    from jama16_retina_tpu_torch.serve.engine import ServingEngine

    fcfg = configs.override(cfg, [
        "serve.bucket_sizes=8", "serve.max_batch=8", "serve.max_wait_ms=200",
        "serve.router_fusion=true"])
    other = [random_member(models.build(fcfg.model),
                           torch.Generator().manual_seed(seed + 600 + m)
                           ).state_dict() for m in range(2)]
    out = {"launches": {}}
    rows8 = canv[:8]
    parts = [(types.SimpleNamespace(model="a"), 0, 4),
             (types.SimpleNamespace(model="b"), 0, 4)]
    for form in ("in_turn", "vmap"):
        ecfg = (fcfg if form == "in_turn" else configs.override(
            fcfg, ["serve.member_parallel=true"]))
        eng_a = ServingEngine(ecfg, dirs, device="cuda", registry=Registry())
        eng_b = ServingEngine(ecfg, state_dicts=other, device="cuda",
                              registry=Registry())
        check(fusion.fusion_token(eng_a) is not None
              and fusion.fusion_token(eng_a) == fusion.fusion_token(eng_b),
              "the tenants' fusion tokens differ")
        ref_a, ref_b = eng_a.probs(rows8[:4]), eng_b.probs(rows8[4:])
        check(not np.array_equal(ref_a, ref_b), "the tenants agree")
        reset_counts([eng_a, eng_b])
        reg = Registry()
        router = router_lib.Router(ecfg, engines={"a": [eng_a],
                                                  "b": [eng_b]},
                                   registry=reg)
        fa = router.submit(rows8[:4], model="a")
        fb = router.submit(rows8[4:], model="b")
        got_a, got_b = fa.result(timeout=120), fb.result(timeout=120)
        router.close()
        counts = check_b4(f"fusion {form}", [eng_a, eng_b], fused_bins=1)
        c = reg.snapshot()["counters"]
        check(eng_a.chunks_dispatched + eng_b.chunks_dispatched == 0
              and c["serve.router.fused_bins"] == 1
              and c["serve.router.fused_rows"] == 8,
              f"fusion {form}: {c}")
        gap = float(max(np.abs(got_a - ref_a).max(),
                        np.abs(got_b - ref_b).max()))
        if form == "in_turn":
            check(np.array_equal(got_a, ref_a)
                  and np.array_equal(got_b, ref_b),
                  f"fused rows differ from the tenants' direct rows by {gap}")
        else:
            check(gap <= FUSED_VMAP_TOL, f"fused member_parallel rows "
                  f"{gap} from the direct ones (bound {FUSED_VMAP_TOL})")
        out["launches"][f"router_fusion_{form}"] = counts
        cache = fusion.FusionCache()
        ebm = {"a": eng_a, "b": eng_b}
        spans = fusion._model_spans(parts)
        fused_t = request_ms(torch, lambda: fusion.score_mixed(
            ebm, rows8, parts, 8, cache=cache))
        grouped_t = request_ms(torch, lambda: fusion._score_grouped(
            ebm, rows8, spans, ["a", "b"]))
        out[form] = {"fused": fused_t, "grouped": grouped_t, "gap": gap}
        how = "bitwise" if gap == 0 else f"bound {FUSED_VMAP_TOL}"
        log(f"router fusion ({form}): tenants a and b (k=2 each, other "
            f"random members, one fusion token), 4 rows each at bucket 8: "
            f"one fused bin, B4 launched {counts['fused_serve_preprocess']} "
            f"time(s); rows vs each tenant's direct rows max |diff| "
            f"{gap:.3e} ({how}); fused {fmt_ms(fused_t)}, grouped "
            f"{fmt_ms(grouped_t)} ({smi})")
    return out


def router_cascade(torch, seed, smi, cfg, distill, cascade) -> dict:
    """13c: two student cascade replicas over one ``EscalationPool`` of
    the ten-member ensemble, serially and speculating."""
    import numpy as np

    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.serve import router as router_lib
    from jama16_retina_tpu_torch.serve.cascade import CascadeEngine
    from jama16_retina_tpu_torch.serve.engine import ServingEngine

    canv = cascade["canvases"]
    n_esc = int(cascade["mask"].sum())
    students = [ServingEngine(cfg, [distill["student"]], device="cuda",
                              registry=Registry()) for _ in range(2)]
    ensemble = ServingEngine(cfg, distill["teacher"], device="cuda",
                             registry=Registry())
    engines = students + [ensemble]
    out = {"launches": {}}
    for speculative, want_rows in ((False, cascade["rows"]),
                                   (True, cascade["spec_rows"])):
        name = "speculative" if speculative else "serial"
        scfg = configs.override(cfg, [
            f"serve.cascade_band={cascade['band']!r}",
            f"serve.cascade_thresholds={cascade['threshold']!r}",
            f"serve.cascade_speculative={speculative}"])
        reset_counts(engines)
        reg = Registry()
        pool = router_lib.EscalationPool([ensemble], registry=reg)
        cascades = [CascadeEngine(scfg, s, pool, registry=reg)
                    for s in students]
        router = router_lib.Router(scfg, engines=cascades, registry=reg)
        futs = [router.submit(canv) for _ in range(2)]
        got = [f.result(timeout=300) for f in futs]
        router.close()
        for c in cascades:
            c.close()
        counts = check_b4(f"cascade {name}", engines)
        c = reg.snapshot()["counters"]
        used = sorted(s["replica"] for f in futs for s in f.segments)
        check(all(np.array_equal(g, want_rows) for g in got),
              f"routed {name} cascade rows differ from phase 12's")
        check(c["serve.router.escalations"] == 2 * n_esc
              and c.get("serve.router.speculations", 0)
              == (2 * len(canv) if speculative else 0)
              and used == [0, 1],
              f"cascade {name}: counters {c}, replicas {used}")
        out["launches"][f"router_cascade_{name}"] = counts
        log(f"router cascade ({name}): 2 student replicas over one "
            f"EscalationPool of the {CASCADE_K}-member ensemble, 2 requests "
            f"of {len(canv)} canvases: rows bitwise phase 12's {name} "
            f"cascade; serve.router.escalations "
            f"{int(c['serve.router.escalations'])} = 2 x the mask's {n_esc};"
            f" serve.router.speculations "
            f"{int(c.get('serve.router.speculations', 0))}; B4 "
            f"{counts['fused_serve_preprocess']} launches, one a chunk")
    return out


def router_scaler(torch, seed, smi, cfg, dirs, canv) -> dict:
    """13d: a replica factory over the k = 2 members; a burst scales up,
    quiet drains."""
    from jama16_retina_tpu_torch import configs, models
    from jama16_retina_tpu_torch.models import convert
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.serve import router as router_lib
    from jama16_retina_tpu_torch.serve.engine import ServingEngine
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

    scfg = configs.override(cfg, [
        "serve.router_replicas=1", "serve.scaler_min_replicas=1",
        "serve.scaler_max_replicas=3",
        f"serve.scaler_window_s={SCALER_WINDOW_S}",
        f"serve.router_shed_rows={8 * ROUTER_BATCH_ROWS}"])
    sds = [convert.flax_to_torch(ckpt_lib.load_member(d),
                                 models.build(cfg.model)) for d in dirs]
    built = []

    def factory(rid):
        eng = ServingEngine(scfg, state_dicts=sds, device="cuda",
                            registry=Registry())
        built.append(eng)
        return eng

    reset_counts([])
    reg = Registry()
    router = router_lib.Router(scfg, replica_factory=factory, registry=reg)
    t0 = time.perf_counter()
    recs = closed_loop(router, canv, SCALER_BURST_S, seed + 50,
                       interactive=0, batch=4)
    burst_s = time.perf_counter() - t0
    peak = len(built)
    deadline = time.monotonic() + 20
    while (time.monotonic() < deadline and not any(
            r["state"] == router_lib.DRAINED
            for r in router.replica_states())):
        time.sleep(0.05)
    states = router.replica_states()
    ledger = router.scaler_ledger()
    router.close()
    counts = check_b4("scaler", built)
    errors = [r[5] for r in recs if r[5] is not None]
    c = reg.snapshot()["counters"]
    check(not errors and peak >= 2 and c["serve.scaler.scale_ups"] >= 1
          and c["serve.scaler.scale_downs"] >= 1
          and any(r["state"] == router_lib.DRAINED for r in states),
          f"scaler: built {peak}, counters {c}, states {states}, errors "
          f"{errors[:3]}")
    log(f"router scaler: replica factory over the k=2 members, "
        f"scaler_min_replicas 1, max 3, window {SCALER_WINDOW_S} s; "
        f"{len(recs)} batch requests of {ROUTER_BATCH_ROWS} rows from 4 "
        f"closed-loop clients in {burst_s:.1f} s: {peak} replicas built, "
        f"{int(c['serve.scaler.scale_ups'])} scale-up(s); then quiet: "
        f"{int(c['serve.scaler.scale_downs'])} scale-down(s), states "
        f"{[r['state'] for r in states]}; B4 "
        f"{counts['fused_serve_preprocess']} launches, one a chunk ({smi})")
    t_first = ledger[0]["t"] if ledger else 0.0
    for d in ledger:
        log(f"router scaler ledger: +{d['t'] - t_first:.2f} s active "
            f"{d['active']} -> desired {d['desired']} ({d['reason']}), "
            f"queue {d['queue_rows']} rows, in flight {d['in_flight_rows']} "
            f"rows, p99 {d['p99_latency_ms']} ms")
    return {"launches": {"router_scaler": counts}, "ledger": ledger,
            "built": peak}


def router_policy(torch, seed, smi, cfg, dirs, canv, root: Path) -> dict:
    """13e: a frontier swept through the router on the card, and the
    policy derived from it, sealed, loaded, applied and served."""
    import numpy as np

    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.serve import policy as policy_lib
    from jama16_retina_tpu_torch.serve import router as router_lib
    from jama16_retina_tpu_torch.serve.engine import ServingEngine

    eng = ServingEngine(cfg, dirs, device="cuda", registry=Registry())
    for b in ROUTER_BUCKETS:
        eng.probs(canv[:b])
    reset_counts([eng])
    frontier = []
    for b in ROUTER_BUCKETS:
        bcfg = configs.override(cfg, [f"serve.bucket_sizes={b}",
                                      f"serve.max_batch={b}",
                                      "serve.max_wait_ms=1"])
        for conc in SWEEP_CONCURRENCY:
            router = router_lib.Router(bcfg, engines=[eng],
                                       registry=Registry())
            t0 = time.perf_counter()
            recs = closed_loop(router, canv, SWEEP_S, seed + 60,
                               interactive=conc, batch=0, rows=b)
            wall = time.perf_counter() - t0
            router.close()
            check(recs and all(r[5] is None for r in recs),
                  "a sweep request failed")
            ms = [r[4] for r in recs]
            frontier.append({
                "bucket": b, "concurrency": conc,
                "images_per_sec": round(b * len(recs) / wall, 3),
                "p50_ms": round(statistics.median(ms), 3),
                "p99_ms": round(nearest_rank(ms, 0.99), 3)})
            log(f"router policy sweep: {frontier[-1]} ({smi})")
    fp = policy_lib.policy_fingerprint(cfg, n_devices=1)
    pol = policy_lib.derive_policy(frontier, fp, source={
        "sweep": "chip_smoke.py phase 13e", "card": smi})
    path = str(root / "serve_policy.json")
    policy_lib.save_policy(path, pol)
    check(policy_lib.load_policy(path) == pol,
          "the policy did not round-trip its artifact")
    fresh = configs.override(configs.get_config("eyepacs_binary"), [
        "model.compute_dtype=float32", f"serve.policy_from={path}"])
    applied, prov = policy_lib.maybe_apply_policy(fresh, n_devices=1)
    check(prov["version"] == pol.version
          and applied.serve.max_batch == pol.max_batch
          and applied.serve.bucket_sizes == pol.bucket_sizes,
          f"policy not applied: {prov}")
    router = router_lib.Router(applied, engines=[eng], registry=Registry(),
                               policy_provenance=prov)
    got = router.submit(canv[:8]).result(timeout=120)
    report = router.report()
    router.close()
    counts = check_b4("policy", [eng])
    check(report["policy"]["version"] == pol.version
          and np.isfinite(got).all(), f"policy router report {report}")
    log(f"router policy: derived from the card's frontier "
        f"({len(frontier)} points): version {pol.version}, max_batch "
        f"{pol.max_batch}, buckets {list(pol.bucket_sizes)}, max_wait_ms "
        f"{pol.max_wait_ms}, shed_in_flight {pol.shed_in_flight}, "
        f"shed_queue_depth {pol.shed_queue_depth}, classes {pol.classes}; "
        f"applied to a fresh config: {prov['applied']}; a router built from "
        f"it served a request ({smi})")
    return {"launches": {"router_policy": counts}, "frontier": frontier,
            "policy": pol.payload()}


def phase_router(torch, seed: int, smi: str, serve: dict, distill: dict,
                 cascade: dict, root: Path) -> dict:
    """Phase 13: the router, fusion, cascade-aware routing, the scaler and
    the policy, on phase 4's k = 2 members and phase 12's student, ten
    members and canvases (float32 compute, TF32 off, fused preprocess).
    Launch counts are set to 0 just before each part and read just
    after."""
    from jama16_retina_tpu_torch import configs

    t_phase = time.perf_counter()
    cfg = configs.override(configs.get_config("eyepacs_binary"), [
        "model.compute_dtype=float32", "serve.fused_preprocess=true",
        "serve.bucket_sizes=" + ",".join(map(str, ROUTER_BUCKETS)),
        "serve.max_batch=64", "serve.router_tick_ms=1"])
    canv, dirs = cascade["canvases"], serve["dirs"]
    parts = (
        ("a", "replicas", lambda: router_replicas(torch, seed, smi, cfg,
                                                  dirs, canv)),
        ("b", "fusion", lambda: router_fusion(torch, seed, smi, cfg, dirs,
                                              canv)),
        ("c", "cascade", lambda: router_cascade(torch, seed, smi, cfg,
                                                distill, cascade)),
        ("d", "scaler", lambda: router_scaler(torch, seed, smi, cfg, dirs,
                                              canv)),
        ("e", "policy", lambda: router_policy(torch, seed, smi, cfg, dirs,
                                              canv, root)))
    out = {"launches": {}}
    for letter, name, fn in parts:
        t0 = time.perf_counter()
        res = fn()
        out["launches"].update(res.pop("launches"))
        out[name] = res
        torch.cuda.empty_cache()
        log(f"times: phase 13{letter} ({name}) wall "
            f"{time.perf_counter() - t0:.1f} s ({smi})")
    log(f"times: phase 13 (router) wall {time.perf_counter() - t_phase:.1f} s"
        f" ({smi})")
    return out


# Phase 14: JPEG records and the host stage without OpenCV.
FIXTURES = ROOT / "tests" / "data" / "jpeg"
# (split, records, shards) of the JPEG splits, and the share of val and
# test records drawn from the 317-px fixtures (the resize path).
JPEG_SPLITS = (("train", 64, 4), ("val", 32, 2), ("test", 32, 2))
JPEG_STREAM_TURNS = (("jpeg", 1), ("raw", 1))
HOST_BATCHES = (1, 8, 64)
PREDICT_BATCH = 8


def fixture_manifest() -> dict:
    with open(FIXTURES / "manifest.json") as f:
        return json.load(f)


def sha256(a) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def phase_fixture_decode() -> dict:
    """(a) Every committed fixture decoded on this machine's host: the
    host path (EXIF applied) bitwise OpenCV's decode, the records path
    (EXIF ignored) bitwise TensorFlow's, by the manifest's digests; an
    arithmetic-coded JPEG refused naming item 14."""
    from jama16_retina_tpu_torch.data import imdecode, jpeg

    manifest = fixture_manifest()
    n_checked = 0
    rgb, why = imdecode.read_image(arithmetic_jpeg())
    check(rgb is None and "item 14" in (why or ""),
          f"arithmetic-coded JPEG: {why}")
    for name, entry in sorted(manifest.items()):
        data = (FIXTURES / name).read_bytes()
        check(sha256(data) == entry["sha256"], f"fixture {name} changed")
        host = imdecode.imdecode(data)
        check(host is not None and sha256(host) == entry["cv2_rgb"],
              f"{name}: the host decode differs from OpenCV's")
        n_checked += 1
        if "tf_rgb" in entry:
            rec = jpeg.decode_jpeg(data, exif_orientation=False)
            check(sha256(rec) == entry["tf_rgb"],
                  f"{name}: the records decode differs from TensorFlow's")
            n_checked += 1
    log(f"jpeg: {n_checked} decodes of {len(manifest)} fixtures bitwise "
        "their manifest digests (OpenCV with EXIF applied, TensorFlow "
        "without), the progressive ones among them; an arithmetic-coded "
        "JPEG refused naming item 14")
    return {"checked": n_checked}


def jpeg_split_sources(split: str, n: int) -> list:
    """(fixture, grade) per record: the 299-px renders with grades
    cycling, and in val and test every fourth record a 317-px render."""
    out = []
    for i in range(n):
        if split != "train" and i % 4 == 0:
            out.append((f"fundus317_{(i // 4) % 4}.jpg", i % 5))
        else:
            out.append((f"fundus299_{i % 8}.jpg", i % 5))
    return out


def write_jpeg_splits(root: Path) -> "tuple[Path, Path]":
    """The fixtures as JPEG TFRecord splits (``make_jpeg_example``), and
    the same decoded pixels as raw splits."""
    from jama16_retina_tpu_torch.data import jpeg, tfrecord

    jdir, rdir = root / "jpeg", root / "raw"
    for split, n, shards in JPEG_SPLITS:
        src = jpeg_split_sources(split, n)
        blobs = {f: (FIXTURES / f).read_bytes() for f, _ in src}
        names = [f"{split}_{i:05d}" for i in range(n)]
        tfrecord.write_example_shards(
            (tfrecord.make_jpeg_example(blobs[f], g, nm)
             for (f, g), nm in zip(src, names)), str(jdir), split, shards)
        tfrecord.write_example_shards(
            (tfrecord.make_raw_example(jpeg.decode_jpeg(
                blobs[f], exif_orientation=False), g, nm)
             for (f, g), nm in zip(src, names)), str(rdir), split, shards)
    return jdir, rdir


def evaluate_card_and_cpu(cfg, data: Path, workdir: Path, root: Path,
                          tag: str, threshold_dir: "Path | None" = None,
                          n_test: int = FIT_SPLITS[2][1]) -> float:
    """``evaluate_checkpoints`` of ``workdir``'s best step on ``test`` with
    thresholds from ``val`` (of ``threshold_dir`` when given), float32
    with TF32 off, on the card and on the CPU: probabilities of the
    ``n_test`` images within 1e-4 and the reports within ``reports_gap``.
    Returns the largest probability difference."""
    import numpy as np

    from jama16_retina_tpu_torch import configs, trainer

    cfg_eval = configs.override(cfg, ["model.compute_dtype=float32"])
    reports, probs = {}, {}
    for dev in ("cuda", "cpu"):
        csv_path = root / f"probs_{tag}_{dev}.csv"
        t0 = time.perf_counter()
        reports[dev] = report = trainer.evaluate_checkpoints(
            cfg_eval, str(data), [str(workdir)], split="test",
            threshold_split="val", save_probs=str(csv_path), device=dev,
            threshold_data_dir=None if threshold_dir is None
            else str(threshold_dir))
        ops = [(round(r["threshold"], 6), r["sensitivity"], r["specificity"])
               for r in report["operating_points"]]
        moved = [(r["sensitivity"], r["specificity"])
                 for r in report["operating_points_transferred"]]
        log(f"{tag}: evaluate {dev}: AUC {report['auc']:.6f}, operating "
            f"points (threshold, sensitivity, specificity) {ops}, "
            f"transferred from val (sensitivity, specificity) {moved} in "
            f"{time.perf_counter() - t0:.2f} s")
        probs[dev] = read_probs_csv(csv_path)
    (names, grades, p_cpu), (names_c, grades_c, p_card) = (
        probs["cpu"], probs["cuda"])
    dev_cpu = float(np.max(np.abs(p_card - p_cpu)))
    log(f"{tag}: evaluate float32 card vs CPU max |prob diff| {dev_cpu:.3e} "
        f"over {p_cpu.size} test images in the save_probs CSVs (6 "
        "decimals; atol 1e-4, TF32 off)")
    check(names == names_c and np.array_equal(grades, grades_c)
          and p_cpu.size == n_test and dev_cpu <= 1e-4,
          f"card and CPU evaluations disagree by {dev_cpu}")
    gap = reports_gap(reports["cuda"], reports["cpu"], p_cpu,
                      (grades >= 2).astype(int), dev_cpu)
    check(gap is None, f"card and CPU evaluation reports disagree: {gap}")
    return dev_cpu


def decode_rates(jdir: Path, rdir: Path, smi: str) -> dict:
    """(c) Images/s of one process decoding the train split's records
    (``readers.decode``: CRC, parse, JPEG decode) and the 1024-px fixture
    (decode, and decode plus the resize to 299), on this host."""
    from jama16_retina_tpu_torch.data import jpeg, readers, tfrecord

    out = {}
    for kind, d in (("jpeg", jdir), ("raw", rdir)):
        records = [r for p in tfrecord.list_split(str(d), "train")
                   for r in tfrecord.read_records(p)]
        readers.decode(records[0], 299)
        t0 = time.perf_counter()
        for r in records:
            readers.decode(r, 299)
        out[f"{kind}_299"] = len(records) / (time.perf_counter() - t0)
    big = (FIXTURES / "fundus1024.jpg").read_bytes()
    for label, fn in (("jpeg_1024", lambda: jpeg.decode_jpeg(
            big, exif_orientation=False)),
            ("jpeg_1024_to_299", lambda: readers.decode(
                tfrecord.make_jpeg_example(big, 0), 299))):
        fn()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        out[label] = 10 / (time.perf_counter() - t0)
    log(f"times: jpeg decode, one process: {out['jpeg_299']:.1f} images/s "
        f"of 299-px JPEG records (raw records {out['raw_299']:.1f}); the "
        f"1024-px fixture {out['jpeg_1024']:.2f} images/s, with the resize "
        f"to 299 {out['jpeg_1024_to_299']:.2f} images/s ({smi})")
    return out


def jpeg_stream_turns(torch, seed: int, smi: str, jdir: Path, rdir: Path,
                      root: Path, out: dict) -> dict:
    """(c) The stream step from the JPEG splits against the same pixels
    written raw, in turns (``JPEG_STREAM_TURNS``) (6-step fits,
    steps 3-5's median ``window_sec`` and ``input_wait_sec``)."""
    streams = {}
    for turn, (kind, readers) in enumerate(JPEG_STREAM_TURNS):
        cfg = fit_config(STREAM_STEPS, root / f"stream{turn}", seed,
                         f"data.readers={readers}",
                         f"train.eval_every={STREAM_STEPS}")
        _, counts, recs = fit_run(torch, cfg, jdir if kind == "jpeg"
                                  else rdir)
        check(counts["fused_color_jitter"] == STREAM_STEPS,
              f"the {kind} stream run launched {counts}")
        train = {r["step"]: r for r in recs if r["kind"] == "train"}
        steady = range(3, STREAM_STEPS)
        step = statistics.median(1e3 * train[s]["window_sec"] for s in steady)
        wait = statistics.median(1e3 * train[s]["input_wait_sec"]
                                 for s in steady)
        streams.setdefault((kind, readers), []).append((step, wait))
        out["launches"][f"jpeg_stream{turn}"] = counts
        log(f"times: jpeg stream {kind} records, data.readers={readers}: "
            f"step median {step:.3f} ms, input wait {wait:.3f} ms (steps "
            f"3-{STREAM_STEPS - 1}) ({smi})")
        shutil.rmtree(root / f"stream{turn}", ignore_errors=True)
    for readers in sorted({r for _, r in JPEG_STREAM_TURNS}):
        j = streams[("jpeg", readers)][0][0]
        r = streams[("raw", readers)][0][0]
        log(f"jpeg: stream step at data.readers={readers}: JPEG {j:.3f} ms "
            f"vs raw {r:.3f} ms ({100 * (j / r - 1):+.1f} %; printed, not "
            f"asserted) ({smi})")
    return streams


def predict_rows(argv) -> "tuple[int, list]":
    import contextlib
    import io

    from jama16_retina_tpu_torch import predict

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = predict.main(argv)
    return code, [json.loads(x) for x in buf.getvalue().splitlines()
                  if x.strip()]


def phase_predict_images(torch, serve: dict, root: Path, smi: str,
                         out: dict) -> None:
    """(d) ``predict.main`` with ``serve.fused_preprocess=true`` on the
    fixture photos, the EXIF-rotated one, the progressive one, a junk file
    and an arithmetic-coded JPEG, against phase 4's k=2 members, with the quality monitor reading
    B4's statistics (so ``serve.preprocess.fused_rows`` counts the rows,
    as the reference's monitor counts them)."""
    import numpy as np

    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.obs import quality
    from jama16_retina_tpu_torch.obs import registry as obs_registry
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.serve import host
    from jama16_retina_tpu_torch.serve.engine import ServingEngine

    images = root / "images"
    images.mkdir(parents=True)
    photos = ([f"fundus299_{i}.jpg" for i in range(8)]
              + [f"fundus317_{i}.jpg" for i in range(4)]
              + ["fundus1024.jpg", "exif6.jpg", "progressive.jpg"])
    for name in photos:
        shutil.copy(FIXTURES / name, images / name)
    (images / "junk.jpg").write_bytes(b"not a jpeg")
    (images / "arithmetic.jpg").write_bytes(arithmetic_jpeg())
    reg = obs_registry.default_registry()

    def counter(name):
        m = reg._metrics.get(name)
        return 0.0 if m is None else m.value

    before = {k: counter(k) for k in (
        "serve.input_rejected", "serve.input_rejected.decode_error",
        "serve.preprocess.fused_rows")}
    grid = np.linspace(0.0, 1.0, 8)
    profile = quality.save_profile(
        str(root / "profile.json"), quality.build_profile(
            grid, stat_values={k: grid for k in quality.INPUT_STATS}))
    sets = ["serve.fused_preprocess=true", "model.compute_dtype=float32",
            "obs.quality.enabled=true", f"obs.quality.profile_path={profile}"]
    argv = [f"--checkpoint_dir={Path(serve['dirs'][0]).parent}",
            f"--images={images}", "--config=eyepacs_binary",
            f"--batch_size={PREDICT_BATCH}", "--threshold=0.5",
            *[a for s in sets for a in ("--set", s)]]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    code, rows = predict_rows(argv)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    out["launches"]["jpeg_predict"] = counts
    delta = {k: counter(k) - v for k, v in before.items()}
    errors = {Path(r["image"]).name: r["error"] for r in rows if "error" in r}
    scored = [r for r in rows if "error" not in r]
    kept = len(photos)
    chunks = -(-kept // PREDICT_BATCH)
    log(f"jpeg: predict --images: exit {code}, {len(scored)} rows, skipped "
        f"{errors}; launches {counts}; counters {delta}; {wall:.2f} s")
    check(code == 0 and len(scored) == kept, f"predict rows {rows}")
    check(errors.get("junk.jpg") == "unreadable"
          and "item 14" in errors.get("arithmetic.jpg", ""),
          f"predict skipped {errors}")
    check(delta["serve.input_rejected"] == 2
          and delta["serve.input_rejected.decode_error"] == 2,
          f"reject counters moved by {delta}")
    check(counts["fused_serve_preprocess"] == chunks
          and sum(counts.values()) == chunks,
          f"predict launched {counts}, want B4 once per chunk ({chunks})")
    check(delta["serve.preprocess.fused_rows"] == kept,
          f"serve.preprocess.fused_rows moved by {delta}")
    probs = np.array([r["prob"] for r in scored])
    check(bool(np.all(np.isfinite(probs))), f"predict rows {probs}")

    # The kept canvases against the manifest, and the rows against the
    # same engine on the CPU.
    manifest = fixture_manifest()
    paths = [str(images / n) for n in sorted(photos)]
    pre = host.preprocess_paths(paths, 299, registry=Registry())
    check([Path(p).name for p in pre.kept]
          == [Path(r["image"]).name for r in scored],
          "predict scored other rows than the host stage keeps")
    bad = [Path(p).name for p, c in zip(pre.kept, pre.images)
           if sha256(c) != manifest[Path(p).name]["canvas299"]]
    check(not bad, f"canvases differ from the manifest: {bad}")
    cfg = configs.override(configs.get_config("eyepacs_binary"), sets + [
        f"serve.max_batch={PREDICT_BATCH}",
        f"serve.bucket_sizes={PREDICT_BATCH}"])
    want = ServingEngine(cfg, serve["dirs"], device="cpu",
                         registry=Registry()).probs(pre.images)
    dev = float(np.max(np.abs(probs - want)))
    log(f"jpeg: predict --images: {kept} canvases bitwise the manifest's "
        f"(host of this machine), card rows vs the CPU engine max |prob "
        f"diff| {dev:.3e} (atol 1e-4, rows at 6 decimals, TF32 off)")
    check(dev <= 1e-4, f"predict rows differ from the CPU engine by {dev}")


def host_stage_times(smi: str) -> dict:
    """(e) The host stage's wall time per batch of 1, 8 and 64 photos at
    299 and 1024 px, with one worker thread and the default."""
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.serve import host

    sources = {299: [str(FIXTURES / f"fundus299_{i}.jpg") for i in range(8)],
               1024: [str(FIXTURES / "fundus1024.jpg")]}
    default = host.resolve_workers(0)
    out = {}
    for size, files in sources.items():
        host.preprocess_paths(files[:1], 299, workers=1, registry=Registry())
        for workers in (1, default):
            for n in HOST_BATCHES:
                paths = [files[i % len(files)] for i in range(n)]
                t0 = time.perf_counter()
                host.preprocess_paths(paths, 299, workers=workers,
                                      registry=Registry())
                ms = 1e3 * (time.perf_counter() - t0)
                out[(size, workers, n)] = ms
                log(f"times: host stage {size}-px JPEG photos -> 299 px, "
                    f"host_workers={workers}, batch {n}: {ms:.1f} ms, "
                    f"{ms / n:.2f} ms an image ({smi})")
    return out


def phase_jpeg_host(torch, seed: int, smi: str, serve: dict) -> dict:
    """JPEG records and the host stage without OpenCV at full width (phase
    14 of the docstring)."""
    t_phase = time.perf_counter()
    root = SCRATCH / "jpeg"
    shutil.rmtree(root, ignore_errors=True)
    out = {"launches": {}}
    out["fixtures"] = phase_fixture_decode()
    t0 = time.perf_counter()
    jdir, rdir = write_jpeg_splits(root)
    log(f"jpeg: wrote JPEG and raw splits {list(JPEG_SPLITS)} (split, "
        f"records, shards) from the fixtures in "
        f"{time.perf_counter() - t0:.2f} s")

    # (b) eyepacs_binary from the JPEG splits, evals at 4 and 8.
    cfg = fit_config(FIT_STEPS, root / "fit", seed)
    res, counts, recs = fit_run(torch, cfg, jdir)
    log(f"jpeg: fit from JPEG records: {res}; launches {counts}")
    out["launches"]["jpeg_fit"] = counts
    check(counts["fused_color_jitter"] == FIT_STEPS
          and counts["fused_normalize_color_jitter"] == 0
          and counts["fused_adamw_update"] == 0,
          f"the JPEG fit launched {counts}, want B1 = {FIT_STEPS}")
    evals = [r for r in recs if r["kind"] == "eval"]
    check([r["step"] for r in evals] == [4, 8]
          and all(0 <= r["val_auc"] <= 1 for r in evals),
          f"the JPEG fit's evals {evals}")
    out["eval_card_vs_cpu"] = evaluate_card_and_cpu(
        cfg, jdir, root / "fit", root, "jpeg")

    # (c) Decode rates and the stream from JPEG against raw.
    out["decode"] = decode_rates(jdir, rdir, smi)
    out["streams"] = jpeg_stream_turns(torch, seed, smi, jdir, rdir, root,
                                       out)
    # (d) predict --images on the card; (e) the host stage's times.
    phase_predict_images(torch, serve, root, smi, out)
    out["host"] = host_stage_times(smi)
    shutil.rmtree(root, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"times: phase 14 (jpeg and host) wall {out['wall_s']:.1f} s ({smi})")
    return out


# Phase 15: telemetry, tracing, the flight recorder and alerts.
OBS_STEPS = 16
OBS_EVAL_EVERY = 8
OBS_FLUSH_S = 0.2
OBS_PROFILE_STEPS = 3
SLOW_STEPS = 24
SIGTERM_STEPS = 400
SIGTERM_AFTER_STEP = 3
OVERHEAD_STEPS = 8
OVERHEAD_TURNS = (False, True)
# The request's turns and timed calls a turn (it costs ~50 ms a call).
OVERHEAD_REQUEST_TURNS = (False, True, True, False)
OVERHEAD_REQUEST_CALLS = 10
LONE_REQUESTS = 10
B1_KERNEL = "color_jitter_kernel"
B2_KERNEL = "normalize_color_jitter"
B3_KERNEL = "adamw_kernel"

_SIGTERM_CHILD = r"""
import sys

if __name__ == "__main__":
    from jama16_retina_tpu_torch import configs, trainer

    data, wd = sys.argv[1], sys.argv[2]
    cfg = configs.override(configs.get_config("eyepacs_binary"),
                           sys.argv[3:])
    trainer.fit(cfg, data, wd, device="cuda")
"""


def parse_prom(text: str) -> dict:
    """Prometheus text exposition -> {series: value}; raises on a line
    that is not a comment, a series and a number."""
    series = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        check(re.fullmatch(r'[a-zA-Z_:][a-zA-Z0-9_:]*(\{le="[^"]+"\})?',
                           name) is not None, f"bad .prom series {line!r}")
        series[name] = float(value)
    return series


def profiled_kernels(trace_dir: Path) -> "list[set]":
    """The device kernel names of each Chrome trace a profiler window
    wrote under ``trace_dir``."""
    out = []
    for path in sorted(trace_dir.glob("*.json")):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        out.append({e["name"] for e in events if e.get("cat") == "kernel"})
    return out


def has_kernel(names, kernel: str) -> bool:
    word = re.compile(rf"(?<![A-Za-z0-9_]){re.escape(kernel)}")
    return any(word.search(n) for n in names)


def obs_fit(torch, seed: int, data: Path, wd: Path, steps: int,
            *extra) -> "tuple[dict, list]":
    """One ``eyepacs_binary`` fit with the planes at their defaults but
    for ``extra``; (launch counts, metrics records)."""
    cfg = fit_config(steps, wd, seed, *extra)
    _, counts, recs = fit_run(torch, cfg, data)
    return counts, recs


def obs_fit_phase(torch, seed: int, smi: str, root: Path, data: Path,
                  out: dict) -> Path:
    """(a) The full-width fit with every plane on."""
    from collections import Counter

    from jama16_retina_tpu_torch.data import tfrecord
    from jama16_retina_tpu_torch.obs import trace as obs_trace

    wd = root / "fit"
    t0 = time.perf_counter()
    counts, recs = obs_fit(
        torch, seed, data, wd, OBS_STEPS, f"train.eval_every={OBS_EVAL_EVERY}",
        "train.use_pallas_fused=true", f"obs.flush_every_s={OBS_FLUSH_S}",
        f"train.profile_steps={OBS_PROFILE_STEPS}", "train.tensorboard=true")
    wall = time.perf_counter() - t0
    out["launches"]["obs_fit"] = counts
    check(counts["fused_normalize_color_jitter"] == OBS_STEPS
          and counts["fused_adamw_update"] == OBS_STEPS
          and counts["fused_color_jitter"] == 0
          and counts["fused_serve_preprocess"] == 0,
          f"the obs fit launched {counts}, want B2 = B3 = {OBS_STEPS}")
    kinds = Counter(r["kind"] for r in recs)
    check(kinds["telemetry"] >= 3 and kinds["heartbeat"] == kinds["telemetry"]
          and kinds["train"] == OBS_STEPS and kinds["eval"] == 2,
          f"obs fit records {dict(kinds)}")
    beats = [r for r in recs if r["kind"] == "heartbeat"]
    check(beats[-1]["step"] == OBS_STEPS, f"last heartbeat {beats[-1]}")
    prom = parse_prom((wd / "telemetry.prom").read_text())
    check(prom.get("trainer_dispatch_s_count") == OBS_STEPS,
          f"telemetry.prom trainer_dispatch_s_count "
          f"{prom.get('trainer_dispatch_s_count')}")
    events = Counter(e["name"] for e in obs_trace.default_tracer().events())
    check(all(events[f"trainer.{k}"] > 0 for k in ("input", "dispatch",
                                                    "pause", "save")),
          f"trace events {dict(events)}")
    [tb] = list((wd / "tb").iterdir())
    n_tb = sum(1 for _ in tfrecord.read_records(str(tb)))
    n_scalars = sum(
        sum(isinstance(v, (int, float)) for k, v in r.items()
            if k not in ("kind", "t", "step"))
        for r in recs if r.get("step") is not None
        and r["kind"] != "heartbeat")
    check(n_tb == 1 + n_scalars, f"tfevents records {n_tb}, want 1 + "
          f"{n_scalars}")
    profiles = [r for r in recs if r["kind"] == "profile"]
    kernels = profiled_kernels(wd / "profile")
    check(len(profiles) == 1 and profiles[0]["steps"] == OBS_PROFILE_STEPS
          and len(kernels) == 1, f"profile records {profiles}")
    check(has_kernel(kernels[0], B2_KERNEL)
          and has_kernel(kernels[0], B3_KERNEL),
          f"the profiler window holds no B2/B3: {sorted(kernels[0])[:20]}")
    ours = sorted(n for n in kernels[0] if any(
        has_kernel([n], k) for k in (B1_KERNEL, B2_KERNEL, B3_KERNEL)))
    log(f"obs: (a) fit of {OBS_STEPS} steps (fused, evals at "
        f"{OBS_EVAL_EVERY} and {OBS_STEPS}) in {wall:.1f} s: launches "
        f"{counts}; records {dict(kinds)}; last heartbeat step "
        f"{beats[-1]['step']}; telemetry.prom parses, {len(prom)} series; "
        f"trace events by name {dict(sorted(events.items()))}; tfevents "
        f"{n_tb} records; profiler window steps "
        f"{OBS_PROFILE_STEPS}: {len(kernels[0])} kernels, ours {ours} "
        f"({smi})")
    out["fit"] = {"records": dict(kinds), "events": dict(events),
                  "tfevents": n_tb, "kernels": ours, "wall_s": wall}
    return wd


def obs_drills(torch, seed: int, smi: str, root: Path, data: Path,
               out: dict) -> None:
    """(b) The slow-step drill in process and the SIGTERM drill in a
    child process."""
    import os
    import signal

    from jama16_retina_tpu_torch.utils.logging import read_jsonl

    wd = root / "slow"
    counts, recs = obs_fit(torch, seed, data, wd, SLOW_STEPS,
                           f"train.eval_every={SLOW_STEPS}",
                           "obs.slow_step_factor=0.5")
    out["launches"]["obs_slow_step"] = counts
    dumps = sorted(p.name for p in (wd / "blackbox").iterdir())
    profiles = [r for r in recs if r["kind"] == "profile"]
    check(dumps == ["01-slow_step"]
          and (wd / "blackbox" / dumps[0] / "diagnosis.json").exists(),
          f"slow-step drill dumps {dumps}")
    check(len(profiles) == 1 and profiles[0].get("trigger") == "anomaly",
          f"slow-step drill profile records {profiles}")
    kernels = profiled_kernels(wd / "profile")
    check(len(kernels) == 1 and has_kernel(kernels[0], B1_KERNEL),
          f"the armed capture holds no B1: {kernels}")
    check(counts["fused_color_jitter"] == SLOW_STEPS,
          f"slow-step drill launched {counts}")
    meta = json.loads((wd / "blackbox" / dumps[0] / "meta.json").read_text())
    diag = json.loads(
        (wd / "blackbox" / dumps[0] / "diagnosis.json").read_text())
    log(f"obs: (b) slow-step drill ({SLOW_STEPS} steps, preset form, "
        f"obs.slow_step_factor=0.5): blackbox {dumps} at step "
        f"{meta['step']} ({meta['step_sec']} s against a median of "
        f"{meta['rolling_median_sec']} s), diagnosis {diag['verdict']} "
        f"(confidence {diag['confidence']}); one armed capture of "
        f"{profiles[0]['steps']} steps holding B1; launches {counts}")

    wd = root / "sigterm"
    args = [f"train.steps={SIGTERM_STEPS}",
            f"train.eval_every={SIGTERM_STEPS}", "train.log_every=1",
            f"train.seed={seed}", f"data.batch_size={TRAIN_BATCH}"]
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-c", _SIGTERM_CHILD, str(data), str(wd), *args],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        metrics = wd / "metrics.jsonl"
        step = 0
        while time.perf_counter() - t0 < 300 and child.poll() is None:
            if metrics.exists():
                steps = [r["step"] for r in read_jsonl(str(metrics))
                         if r["kind"] == "train"]
                step = max(steps, default=0)
                if step >= SIGTERM_AFTER_STEP:
                    break
            time.sleep(0.2)
        check(child.poll() is None and step >= SIGTERM_AFTER_STEP,
              f"the SIGTERM child did not reach step {SIGTERM_AFTER_STEP} "
              f"(exit {child.poll()})")
        child.send_signal(signal.SIGTERM)
        _, err = child.communicate(timeout=180)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    recs = read_jsonl(str(wd / "metrics.jsonl"))
    saves = [r for r in recs if r["kind"] == "preempt_save"]
    dumps = sorted(os.listdir(wd / "blackbox"))
    check(child.returncode == 128 + signal.SIGTERM,
          f"the SIGTERM child exited {child.returncode}: {err[-2000:]}")
    check(dumps == ["01-sigterm"] and len(saves) == 1,
          f"SIGTERM drill: dumps {dumps}, preempt_save records {saves}")
    meta = json.loads((wd / "blackbox" / dumps[0] / "meta.json").read_text())
    log(f"obs: (b) SIGTERM drill: a child fit sent SIGTERM after step "
        f"{step} exited {child.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; blackbox {dumps} (signal "
        f"{meta['signal']}, step {meta['step']}); preempt_save {saves[0]}")
    out["drills"] = {"slow_step": meta, "sigterm_save": saves[0]}


def obs_predict(torch, smi: str, root: Path, fit_wd: Path,
                out: dict) -> None:
    """(c) predict --obs_workdir over (a)'s member, a rule that fires."""
    from collections import Counter

    from jama16_retina_tpu_torch.utils.logging import read_jsonl

    photos = sorted(FIXTURES.glob("fundus299_*.jpg"))
    wd = root / "predict"
    batch = 4
    argv = [f"--checkpoint_dir={fit_wd}", f"--images={FIXTURES}/fundus299_*",
            "--config=eyepacs_binary", f"--batch_size={batch}",
            f"--obs_workdir={wd}",
            "--set", "serve.fused_preprocess=true",
            "--set", "obs.flush_every_s=0",
            "--set", "obs.quality.alert_rules=serve.engine.rows > 0 -> "
                     "slo_breach"]
    torch.cuda.synchronize()
    reset_launch_counts()
    code, rows = predict_rows(argv)
    counts = launch_counts()
    out["launches"]["obs_predict"] = counts
    chunks = -(-len(photos) // batch)
    check(code == 0 and len(rows) == len(photos)
          and all("error" not in r for r in rows), f"predict rows {rows}")
    check(counts["fused_serve_preprocess"] == chunks
          and sum(counts.values()) == chunks,
          f"predict --obs_workdir launched {counts}, want B4 = {chunks}")
    recs = read_jsonl(str(wd / "metrics.jsonl"))
    kinds = Counter(r["kind"] for r in recs)
    alerts = [{k: r[k] for k in ("rule", "state", "value", "reason")}
              for r in recs if r["kind"] == "alert"]
    beats = [r for r in recs if r["kind"] == "heartbeat"]
    dumps = sorted(p.name for p in (wd / "blackbox").iterdir())
    check(alerts and alerts[0]["state"] == "firing"
          and dumps == ["01-slo_breach"] and beats[-1]["step"] == len(photos)
          and len(beats) >= chunks + 1,
          f"predict --obs_workdir: alerts {alerts}, dumps {dumps}, "
          f"heartbeats {beats}")
    files = sorted(p.name for p in (wd / "blackbox" / dumps[0]).iterdir())
    log(f"obs: (c) predict --obs_workdir on {len(photos)} photos at batch "
        f"{batch}: exit {code}; launches {counts}; records {dict(kinds)}; "
        f"alerts {alerts}; blackbox {dumps} {files}; heartbeat steps "
        f"{[b['step'] for b in beats]}, the final one {beats[-1]}")
    out["predict"] = {"records": dict(kinds), "alerts": alerts}


def _seg_ms(events, name) -> dict:
    """trace_id -> ms of the complete events called ``name``."""
    return {e["args"]["trace_id"]: e["dur"] / 1e3 for e in events
            if e["name"] == name and "args" in e}


def _spans_in(events, name, tid, lo_us, hi_us) -> "tuple[int, float]":
    """(count, ms) of ``name`` spans on thread ``tid`` inside [lo, hi]."""
    spans = [e for e in events if e["name"] == name and e["tid"] == tid
             and e["ts"] >= lo_us and e["ts"] + e["dur"] <= hi_us]
    return len(spans), sum(e["dur"] for e in spans) / 1e3


def obs_lone_request(torch, seed: int, smi: str, serve: dict,
                     out: dict) -> None:
    """(d) Where a routed lone batch-8 request's wall time goes."""
    import threading

    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.obs import trace as obs_trace
    from jama16_retina_tpu_torch.serve import router as router_lib
    from jama16_retina_tpu_torch.serve.engine import ServingEngine

    cfg = configs.override(configs.get_config("eyepacs_binary"), [
        "model.compute_dtype=float32", "serve.fused_preprocess=true",
        "serve.bucket_sizes=" + ",".join(map(str, ROUTER_BUCKETS)),
        "serve.max_batch=64", "serve.router_tick_ms=1"])
    engine = ServingEngine(cfg, serve["dirs"], device="cuda")
    tracer = obs_trace.default_tracer()
    check(tracer.enabled, "the engine left the process tracer off")
    x8 = render(seed + 40, 8)
    router = router_lib.Router(cfg, engines=[engine])
    rows = {}
    try:
        for path, fn in (("routed", lambda: router.submit(x8).result()),
                         ("engine", lambda: engine.probs(x8))):
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            tracer.clear()
            walls = []
            for _ in range(LONE_REQUESTS):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((t0, time.perf_counter()))
            # Event ts count from the tracer's epoch, which clear() moves.
            rows[path] = (walls, tracer.events(), tracer.epoch)
    finally:
        router.close()
    caller = threading.get_ident()
    walls, events, epoch = rows["routed"]
    qw = _seg_ms(events, "serve.router.request.queue_wait")
    dv = _seg_ms(events, "serve.router.request.device")
    rs = _seg_ms(events, "serve.router.request.resolve")
    check(len(qw) == len(dv) == len(rs) == LONE_REQUESTS,
          f"{len(qw)} routed requests traced of {LONE_REQUESTS}")
    tick_tid = next(e["tid"] for e in events
                    if e["name"] == "serve.router.tick_s")
    worker_tid = next(e["tid"] for e in events
                      if e["name"] == "serve.router.request.device")
    # Submission order is queue_wait order.
    ids = [e["args"]["trace_id"] for e in sorted(
        (e for e in events
         if e["name"] == "serve.router.request.queue_wait"),
        key=lambda e: e["ts"])]
    split = []
    for (t0, t1), tid in zip(walls, ids):
        lo, hi = (t0 - epoch) * 1e6, (t1 - epoch) * 1e6
        n_ticks, tick_ms = _spans_in(events, "serve.router.tick_s",
                                     tick_tid, lo, hi)
        eng = {k: _spans_in(events, f"serve.engine.{k}_s", worker_tid, lo,
                            hi)[1] for k in ("pad", "dispatch", "device_get")}
        wall = (t1 - t0) * 1e3
        split.append({"wall": wall, "queue_wait": qw[tid],
                      "device": dv[tid], "resolve": rs[tid],
                      "caller_rest": wall - qw[tid] - dv[tid] - rs[tid],
                      "ticks": n_ticks, "tick_ms": tick_ms,
                      "worker_engine": sum(eng.values()),
                      "worker_rest": dv[tid] - sum(eng.values()), **eng})
    walls_e, events_e, epoch = rows["engine"]
    eng_split = []
    for t0, t1 in walls_e:
        lo, hi = (t0 - epoch) * 1e6, (t1 - epoch) * 1e6
        eng = {k: _spans_in(events_e, f"serve.engine.{k}_s", caller, lo,
                            hi)[1] for k in ("pad", "dispatch", "device_get")}
        wall = (t1 - t0) * 1e3
        eng_split.append({"wall": wall, **eng,
                          "rest": wall - sum(eng.values())})

    def med(rows_, key):
        return statistics.median(r[key] for r in rows_)

    keys = ("wall", "queue_wait", "device", "resolve", "caller_rest",
            "ticks", "tick_ms", "pad", "dispatch", "device_get",
            "worker_engine", "worker_rest")
    r_med = {k: round(med(split, k), 3) for k in keys}
    e_med = {k: round(med(eng_split, k), 3)
             for k in ("wall", "pad", "dispatch", "device_get", "rest")}
    log(f"obs: (d) lone batch-8 request (float32, k=2, fused preprocess, "
        f"tick 1 ms), medians of {LONE_REQUESTS} after 2 warm, ms: routed "
        f"{r_med} (the caller thread: wall, caller_rest; the tick thread: "
        f"ticks, tick_ms inside the request; the replica worker: device = "
        f"pad + dispatch + device_get + worker_rest, then resolve); the "
        f"engine alone on the caller thread {e_med} ({smi})")
    out["lone_request"] = {"routed": r_med, "engine": e_med,
                           "routed_walls": [round(r["wall"], 3)
                                            for r in split]}


def obs_overhead(torch, seed: int, smi: str, root: Path, data: Path,
                 serve: dict, out: dict) -> None:
    """(e) The planes' cost on the fused step and the batch-8 request."""
    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.obs import registry as obs_registry
    from jama16_retina_tpu_torch.obs import trace as obs_trace
    from jama16_retina_tpu_torch.serve.engine import ServingEngine

    steps = {False: [], True: []}
    # Each fit's per-step windows (log_every 1) but the first two
    # (warm-up).
    for i, on in enumerate(OVERHEAD_TURNS):
        _, recs = obs_fit(torch, seed, data, root / f"overhead{i}",
                          OVERHEAD_STEPS,
                          f"train.eval_every={OVERHEAD_STEPS}",
                          "train.use_pallas_fused=true",
                          f"obs.enabled={str(on).lower()}")
        steps[on] += [r["window_sec"] * 1e3 for r in recs
                      if r["kind"] == "train" and r["step"] >= 3]
    cfg = configs.override(configs.get_config("eyepacs_binary"), [
        "serve.bucket_sizes=8", "serve.max_batch=8"])
    engine = ServingEngine(cfg, serve["dirs"], device="cuda")
    reg, tracer = obs_registry.default_registry(), obs_trace.default_tracer()
    x8 = render(seed + 41, 8)
    req = {False: [], True: []}
    try:
        for on in OVERHEAD_REQUEST_TURNS:
            # What obs.enabled=false does to the engine's path: the
            # registry's and the tracer's ops become one branch.
            reg.enabled = tracer.enabled = on
            for i in range(2 + OVERHEAD_REQUEST_CALLS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.probs(x8)
                torch.cuda.synchronize()
                if i >= 2:
                    req[on].append((time.perf_counter() - t0) * 1e3)
    finally:
        reg.enabled = tracer.enabled = True

    def summary(v):
        return (statistics.median(v), min(v), max(v), len(v))

    res = {}
    for name, on in (("off", False), ("on", True)):
        res[f"step_{name}"] = summary(steps[on])
        res[f"request_{name}"] = summary(req[on])
    for k, (m, lo, hi, n) in res.items():
        log(f"times: obs overhead {k}: median {m:.3f} ms, range "
            f"{lo:.3f}-{hi:.3f} over {n} ({smi})")
    step_pct = 100 * (res["step_on"][0] / res["step_off"][0] - 1)
    req_pct = 100 * (res["request_on"][0] / res["request_off"][0] - 1)
    log(f"obs: (e) the planes on against obs.enabled=false: fused step "
        f"(bf16, batch 32, steps 3-{OVERHEAD_STEPS} of each fit's windows, "
        f"fits in turns {list(OVERHEAD_TURNS)}) {step_pct:+.2f} %, batch-8 "
        f"request (bf16, k=2, {OVERHEAD_REQUEST_CALLS} calls a turn, turns "
        f"{list(OVERHEAD_REQUEST_TURNS)}) {req_pct:+.2f} % ({smi})")
    out["overhead"] = {**res, "step_pct": step_pct, "request_pct": req_pct}


def phase_obs(torch, seed: int, smi: str, serve: dict, data: Path) -> dict:
    """Telemetry, tracing, the flight recorder and alerts at full width
    (phase 15 of the docstring), on phase 6's splits ``data``."""
    t_phase = time.perf_counter()
    root = SCRATCH / "obs"
    shutil.rmtree(root, ignore_errors=True)
    out = {"launches": {}}
    torch.cuda.empty_cache()
    marks = [time.perf_counter()]
    fit_wd = obs_fit_phase(torch, seed, smi, root, data, out)
    marks.append(time.perf_counter())
    obs_drills(torch, seed, smi, root, data, out)
    marks.append(time.perf_counter())
    obs_predict(torch, smi, root, fit_wd, out)
    marks.append(time.perf_counter())
    obs_lone_request(torch, seed, smi, serve, out)
    marks.append(time.perf_counter())
    obs_overhead(torch, seed, smi, root, data, serve, out)
    marks.append(time.perf_counter())
    shutil.rmtree(root, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    parts = [round(b - a, 1) for a, b in zip(marks, marks[1:])]
    log(f"times: phase 15 (obs) wall {out['wall_s']:.1f} s (fit, drills, "
        f"predict, lone request, overhead: {parts}) ({smi})")
    return out


# Phase 16: fault injection and bounded retries.
FAULT_STREAM_BATCHES = 8
FAULT_FIT_STEPS = 8
FAULT_STEP_CALL = 6
KILL_STEPS = 4
KILL_EVAL_EVERY = 2
KILL_HOLD_S = 120.0
DISPATCH_REQUESTS = 10
ROUTER_FAULT_REQUESTS = 16
FAULT_READ = {"tfrecord.read": {"kind": "error", "error": "OSError",
                                "on_calls": [3], "message": "flap"}}


def fault_spec(plan: dict) -> str:
    """A plan as the ``--set obs.fault_plan=...`` value."""
    return "obs.fault_plan=" + json.dumps(plan, separators=(",", ":"))


class FaultDrill:
    """One drill of phase 16: times it, and on the way out checks that no
    plan is armed and ``JAMA16_FAULTS`` is not set (a drill leaving either
    would fire inside every later phase), then clears both."""

    def __init__(self, name: str, out: dict):
        self.name, self.out = name, out

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *_):
        import os

        from jama16_retina_tpu_torch.obs import faultinject

        leaked = faultinject.active_plan()
        env = os.environ.pop(faultinject.ENV_VAR, None)
        faultinject.disarm()
        wall = time.perf_counter() - self.t0
        self.out["wall_s"][self.name] = wall
        if exc_type is None:
            check(leaked is None and env is None,
                  f"faults ({self.name}): the plan {leaked} or "
                  f"{faultinject.ENV_VAR}={env!r} outlived the drill")
            log(f"times: faults ({self.name}) wall {wall:.1f} s")
        return False


def fresh_registry():
    """A fresh process registry; returns the previous one."""
    from jama16_retina_tpu_torch.obs import registry as obs_registry

    return obs_registry.set_default_registry(obs_registry.Registry())


def process_counter(name: str) -> float:
    from jama16_retina_tpu_torch.obs import registry as obs_registry

    return obs_registry.default_registry().snapshot()["counters"].get(name, 0)


def faults_read(torch, seed: int, data: Path, root: Path, out: dict) -> None:
    """(a) ``tfrecord.read``: the stream and a preset-form fit under an
    OSError on call 3, at one reader process and at two."""
    from jama16_retina_tpu_torch.data import pipeline
    from jama16_retina_tpu_torch.obs import faultinject
    from jama16_retina_tpu_torch.obs import registry as obs_registry

    cfg = fit_config(FAULT_FIT_STEPS, root / "read", seed)

    def stream(readers: int) -> list:
        it = pipeline.train_batches(str(data), "train", cfg.data,
                                    cfg.model.image_size, seed=seed,
                                    readers=readers)
        try:
            return [next(it) for _ in range(FAULT_STREAM_BATCHES)]
        finally:
            it.close()

    clean = stream(1)
    for readers in (1, 2):
        prev = fresh_registry()
        try:
            plan = faultinject.plan_from_spec(FAULT_READ)
            faultinject.arm(plan)
            got = stream(readers)
            faultinject.disarm()
            retried = process_counter("io.retries.tfrecord.read")
        finally:
            obs_registry.set_default_registry(prev)
        fires = plan.counts()["tfrecord.read"]["fires"]
        check(all(torch.equal(g[k], w[k]) for g, w in zip(got, clean)
                  for k in w), f"faults (a): the stream at {readers} "
              "reader(s) under the plan differs from the unarmed stream")
        check(retried == fires and 1 <= fires <= readers
              and (readers == 2 or fires == 1),
              f"faults (a): stream at {readers} reader(s): retries "
              f"{retried}, plan {plan.counts()}")
        log(f"faults: (a) stream at data.readers={readers}: "
            f"{FAULT_STREAM_BATCHES} batches of {cfg.data.batch_size} "
            f"bitwise the unarmed stream; io.retries.tfrecord.read "
            f"{retried}; counts {plan.counts()}")
        wd = root / f"read_{readers}"
        fcfg = fit_config(FAULT_FIT_STEPS, wd, seed,
                          f"train.eval_every={FAULT_FIT_STEPS}",
                          f"data.readers={readers}", fault_spec(FAULT_READ))
        _, counts, recs = fit_run(torch, fcfg, data)
        plan = faultinject.active_plan()  # the trainer armed it
        check(plan is not None, "faults (a): the fit armed no plan")
        faultinject.disarm()
        retried = process_counter("io.retries.tfrecord.read")
        fires = plan.counts()["tfrecord.read"]["fires"]
        out["launches"][f"faults_read_fit_r{readers}"] = counts
        check(counts == {"fused_color_jitter": FAULT_FIT_STEPS,
                         "fused_normalize_color_jitter": 0,
                         "fused_adamw_update": 0,
                         "fused_serve_preprocess": 0},
              f"faults (a): the fit at {readers} reader(s) launched {counts}")
        check(max(r["step"] for r in recs if r["kind"] == "train")
              == FAULT_FIT_STEPS, "faults (a): the fit did not finish")
        check(retried == fires and 1 <= fires <= readers
              and (readers == 2 or fires == 1),
              f"faults (a): the fit at {readers} reader(s): trainer "
              f"io.retries.tfrecord.read {retried}, plan {plan.counts()}")
        log(f"faults: (a) {FAULT_FIT_STEPS}-step preset fit at "
            f"data.readers={readers} under obs.fault_plan: trainer "
            f"io.retries.tfrecord.read {retried}, plan counts "
            f"{plan.counts()} (ordinals per reader); launches {counts}")
        shutil.rmtree(wd, ignore_errors=True)


def faults_step_and_restore(torch, seed: int, data: Path, root: Path,
                            out: dict) -> None:
    """(b) ``trainer.step`` cuts a fused fit after step 5; its resume runs
    under a ``ckpt.restore`` OSError on call 1."""
    import os

    import numpy as np

    from jama16_retina_tpu_torch import train_lib, trainer
    from jama16_retina_tpu_torch.obs import faultinject
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
    from jama16_retina_tpu_torch.utils.logging import read_jsonl

    wd = root / "step"
    step_plan = {"trainer.step": {"kind": "error", "error": "RuntimeError",
                                  "on_calls": [FAULT_STEP_CALL],
                                  "message": "chaos step"}}
    cfg = fit_config(FAULT_FIT_STEPS, wd, seed, "train.use_pallas_fused=true",
                     fault_spec(step_plan))
    torch.cuda.synchronize()
    reset_launch_counts()
    try:
        trainer.fit(cfg, str(data), str(wd), device="cuda")
        raised = None
    except RuntimeError as e:
        raised = str(e)
    counts = launch_counts()
    plan = faultinject.active_plan()
    faultinject.disarm()
    done = FAULT_STEP_CALL - 1
    out["launches"]["faults_step_cut"] = counts
    recs = read_jsonl(str(wd / trainer.METRICS_FILE))
    dumps = sorted(os.listdir(wd / "blackbox"))
    evals = [r["step"] for r in recs if r["kind"] == "eval"]
    check(raised is not None and "chaos step" in raised,
          f"faults (b): the fit under trainer.step raised {raised!r}")
    check(len(dumps) == 1 and dumps[0].endswith("exception")
          and not any(r["kind"] == "preempt_save" for r in recs)
          and evals == [FIT_EVAL_EVERY],
          f"faults (b): blackboxes {dumps}, evals {evals}, preempt_save "
          f"{[r for r in recs if r['kind'] == 'preempt_save']}")
    check(counts["fused_normalize_color_jitter"] == done
          and counts["fused_adamw_update"] == done
          and counts["fused_color_jitter"] == 0,
          f"faults (b): the cut fit launched {counts}, want B2 = B3 = {done}")
    log(f"faults: (b) {FAULT_FIT_STEPS}-step fused fit under trainer.step "
        f"RuntimeError on call {FAULT_STEP_CALL}: raised {raised!r}; "
        f"blackbox {dumps}, no preempt_save, evals at {evals}; launches "
        f"{counts}; counts {plan.counts()}")

    saved = ckpt_lib.Checkpointer(str(wd)).restore(FIT_EVAL_EVERY)
    restore_plan = {"ckpt.restore": {"kind": "error", "error": "OSError",
                                     "on_calls": [1]}}
    rcfg = fit_config(FAULT_FIT_STEPS, wd, seed, "train.use_pallas_fused=true",
                      "train.resume=true", fault_spec(restore_plan))
    real, restored = trainer._load_restored, {}

    def capture(state, ckpt, step):
        out_state = real(state, ckpt, step)
        restored.update(train_lib.state_to_flat(state))
        return out_state

    trainer._load_restored = capture
    try:
        res, counts, recs = fit_run(torch, rcfg, data)
    finally:
        trainer._load_restored = real
    plan = faultinject.active_plan()
    faultinject.disarm()
    retried = process_counter("io.retries.ckpt.restore")
    out["launches"]["faults_restore_resume"] = counts
    rest = FAULT_FIT_STEPS - FIT_EVAL_EVERY
    check(retried == 1 and plan.counts()["ckpt.restore"] == {
        "calls": 2, "fires": 1}, f"faults (b): resume io.retries.ckpt."
          f"restore {retried}, plan {plan.counts()}")
    check([r["step"] for r in recs if r["kind"] == "resume"]
          == [FIT_EVAL_EVERY] and ckpt_lib.Checkpointer(
              str(wd)).latest_step == FAULT_FIT_STEPS,
          f"faults (b): the resume did not run from {FIT_EVAL_EVERY} to "
          f"{FAULT_FIT_STEPS}")
    check(counts["fused_normalize_color_jitter"] == rest
          and counts["fused_adamw_update"] == rest,
          f"faults (b): the resume launched {counts}, want B2 = B3 = {rest}")
    check(set(restored) == set(saved) and all(
        np.array_equal(restored[k], saved[k]) for k in saved),
        "faults (b): the state restored on the card differs from the "
        f"step-{FIT_EVAL_EVERY} checkpoint")
    log(f"faults: (b) resume under ckpt.restore OSError on call 1: "
        f"io.retries.ckpt.restore {retried}, counts {plan.counts()}; ran "
        f"{FIT_EVAL_EVERY} -> {FAULT_FIT_STEPS}, best {res}; the restored "
        f"state bitwise the step-{FIT_EVAL_EVERY} checkpoint "
        f"({len(saved)} arrays); launches {counts}")
    shutil.rmtree(wd, ignore_errors=True)


def faults_kill9(torch, seed: int, data: Path, root: Path,
                 out: dict) -> None:
    """(c) ``ckpt.save``: a child fit with ``train.async_save`` whose
    second eval-time save is held by a latency plan (``JAMA16_FAULTS`` in
    the child's env only) is killed with SIGKILL, its process group with
    it (the reader processes and their forkserver)."""
    import os
    import signal

    from jama16_retina_tpu_torch.obs import faultinject
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
    from jama16_retina_tpu_torch.utils.logging import read_jsonl

    wd = root / "kill9"
    args = [f"train.steps={KILL_STEPS}", f"train.eval_every={KILL_EVAL_EVERY}",
            "train.log_every=1", f"train.seed={seed}",
            f"data.batch_size={TRAIN_BATCH}", "train.async_save=true"]
    hold = {"ckpt.save": {"kind": "latency", "on_calls": [2],
                          "delay_s": KILL_HOLD_S}}
    env = dict(os.environ, **{faultinject.ENV_VAR: json.dumps(hold)})
    t0 = time.perf_counter()
    # A session of its own: its reader processes, their forkserver and its
    # resource tracker are found by session id after the kill.
    errlog = root / "kill9.stderr"
    with open(errlog, "w") as errf:
        child = subprocess.Popen(
            [sys.executable, "-c", _SIGTERM_CHILD, str(data), str(wd),
             *args], cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=errf, start_new_session=True)
    try:
        metrics = wd / "metrics.jsonl"
        held = False
        # The kill lands once the step-4 save is held and the step-2 save
        # (queued before it on the one saver thread) has landed: on a slow
        # disk the step-2 write can outlast the steps and eval after it.
        while time.perf_counter() - t0 < 300 and child.poll() is None:
            if metrics.exists() and any(
                    r["kind"] == "eval" and r["step"] == KILL_STEPS
                    for r in read_jsonl(str(metrics))) and ckpt_lib.\
                    Checkpointer(str(wd)).latest_step == KILL_EVAL_EVERY:
                held = True
                break
            time.sleep(0.1)
        check(held and child.poll() is None,
              f"the kill -9 child did not reach its step-{KILL_STEPS} eval "
              f"with its step-{KILL_EVAL_EVERY} save landed (exit "
              f"{child.poll()})")
        time.sleep(0.5)  # the saver sleeps inside the held save now
        child.kill()
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        reaped = reap_session(child.pid)
    err = errlog.read_text()
    check(child.returncode == -signal.SIGKILL,
          f"the kill -9 child exited {child.returncode}: {err[-2000:]}")
    ck = ckpt_lib.Checkpointer(str(wd))
    left = ck.latest_step
    check(left in (KILL_EVAL_EVERY, KILL_STEPS) and set(ck.restore(left)),
          f"faults (c): latest/ after the kill is {left}")
    cfg = fit_config(KILL_STEPS, wd, seed, f"train.eval_every={KILL_EVAL_EVERY}",
                     "train.async_save=true", "train.resume=true")
    res, counts, recs = fit_run(torch, cfg, data)
    out["launches"]["faults_kill9_resume"] = counts
    check([r["step"] for r in recs if r["kind"] == "resume"] == [left]
          and ckpt_lib.Checkpointer(str(wd)).latest_step == KILL_STEPS
          and counts["fused_color_jitter"] == KILL_STEPS - left,
          f"faults (c): the resume from {left}: {res}, launches {counts}")
    log(f"faults: (c) kill -9 of a child fit (train.async_save) while its "
        f"step-{KILL_STEPS} save was held by a ckpt.save latency plan, after "
        f"{time.perf_counter() - t0:.1f} s (its session's {reaped}); "
        f"latest/ whole at step {left}; "
        f"the resume ran {left} -> {KILL_STEPS} ({res}); launches {counts}")
    shutil.rmtree(wd, ignore_errors=True)


def session_members(sid: int) -> "list[int]":
    """Live processes of session ``sid`` (from ``/proc``)."""
    import os

    pids = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        # Fields after the command: state, ppid, pgrp, session, ...
        if int(fields[3]) == sid and fields[0] != "Z":
            pids.append(int(d))
    return pids


def _cmdline(pid: int) -> bytes:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read()
    except OSError:
        return b""


def reap_session(sid: int) -> str:
    """Stop what a killed session leader left: its reader processes and
    their forkserver first (SIGKILL), then up to 10 s for its resource
    tracker, which unlinks the shared memory they held and exits once
    they are gone; anything left after that is killed. Returns what it
    did, for the log."""
    import os
    import signal

    def wait_gone(pids, seconds):
        deadline = time.perf_counter() + seconds
        while time.perf_counter() < deadline:
            alive = set(session_members(sid)) & set(pids)
            if not alive:
                return
            time.sleep(0.1)

    helpers = [p for p in session_members(sid)
               if b"resource_tracker" not in _cmdline(p)]
    for p in helpers:
        try:
            os.kill(p, signal.SIGKILL)
        except ProcessLookupError:
            pass
    wait_gone(helpers, 10)
    tracker = session_members(sid)
    wait_gone(tracker, 10)
    left = session_members(sid)
    if left:
        os.killpg(sid, signal.SIGKILL)
    return (f"{len(helpers)} helper(s) killed, resource tracker "
            f"{'killed' if left else 'exited by itself'}")


def faults_dispatch(torch, seed: int, serve: dict, out: dict) -> None:
    """(d) ``engine.dispatch`` under phase 10's micro-batcher: phase 4's
    k=2 members, bf16, the fused preprocess, one bucket of 8."""
    import numpy as np

    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.obs import faultinject
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.serve.engine import ServingEngine

    cfg = configs.override(configs.get_config("eyepacs_binary"), [
        "serve.fused_preprocess=true", "serve.max_batch=8",
        "serve.bucket_sizes=8"])
    reg = Registry()
    eng = ServingEngine(cfg, serve["dirs"], device="cuda", registry=reg)
    canv = render(seed + 900, 8 * (DISPATCH_REQUESTS + 2))
    reqs = [canv[8 * i:8 * i + 8] for i in range(DISPATCH_REQUESTS + 2)]
    want = [eng.probs(r) for r in reqs]
    b = eng.make_batcher()
    plan = faultinject.plan_from_spec({"engine.dispatch": {
        "kind": "error", "error": "RuntimeError", "on_calls": [2],
        "message": "chaos dispatch"}})
    reset_counts([eng])
    try:
        faultinject.arm(plan)
        got = []
        for r in reqs:
            try:
                got.append(b.submit(r).result(timeout=120))
            except RuntimeError as e:
                got.append(str(e))
        faultinject.disarm()
    finally:
        b.close()
    counts = check_b4("faults (d)", [eng])
    out["launches"]["faults_dispatch"] = counts
    failed = [i for i, g in enumerate(got) if isinstance(g, str)]
    check(failed == [1] and "chaos dispatch" in got[1]
          and reg.counter("serve.batcher.window_errors").value == 1,
          f"faults (d): failed requests {failed}, plan {plan.counts()}")
    check(all(np.array_equal(got[i], want[i]) for i in range(len(reqs))
              if i != 1), "faults (d): batcher rows after the injected "
          "window differ from the unarmed engine's")
    check(counts["fused_serve_preprocess"] == len(reqs) - 1,
          f"faults (d): launches {counts}")
    log(f"faults: (d) engine.dispatch RuntimeError on call 2 under the "
        f"micro-batcher (bf16, bucket 8): request 1 of {len(reqs)} failed "
        f"({got[1]!r}), serve.batcher.window_errors 1, the worker served "
        f"the next {len(reqs) - 2} bitwise the unarmed engine; counts "
        f"{plan.counts()}; launches {counts}")


def faults_router(torch, seed: int, serve: dict, out: dict) -> None:
    """(e) ``serve.router.dispatch`` kills a replica of phase 13a's router
    (two replicas of the k=2 engine, float32, the fused preprocess, tick
    1 ms; one bucket of 8, so every row can be held against its engine's
    score at that bucket)."""
    import numpy as np

    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.obs import faultinject
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.serve import router as router_lib
    from jama16_retina_tpu_torch.serve.engine import ServingEngine

    cfg = configs.override(configs.get_config("eyepacs_binary"), [
        "model.compute_dtype=float32", "serve.fused_preprocess=true",
        "serve.bucket_sizes=8", "serve.max_batch=8",
        "serve.router_tick_ms=1"])
    engines = [ServingEngine(cfg, serve["dirs"], device="cuda",
                             registry=Registry()) for _ in range(2)]
    canv = render(seed + 950, 8 * ROUTER_FAULT_REQUESTS)
    # Each replica engine's score of every canvas at the one bucket.
    tables = [np.concatenate([e.probs(canv[i:i + 8])
                              for i in range(0, len(canv), 8)])
              for e in engines]
    reg = Registry()
    router = router_lib.Router(cfg, engines=engines, registry=reg)
    plan = faultinject.plan_from_spec({"serve.router.dispatch": {
        "kind": "error", "error": "RuntimeError", "on_calls": [2],
        "message": "replica died"}})
    reset_counts(engines)
    try:
        faultinject.arm(plan)
        futs = [router.submit(canv[i:i + 8]) for i in range(0, len(canv), 8)]
        errors, wrong = [], 0
        for lo, f in zip(range(0, len(canv), 8), futs):
            try:
                rows = f.result(timeout=120)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))
                continue
            for seg in f.segments:
                a, b = seg["lo"], seg["hi"]
                wrong += not np.array_equal(
                    rows[a:b], tables[seg["replica"]][lo + a:lo + b])
        faultinject.disarm()
    finally:
        router.close()
    counts = check_b4("faults (e)", engines)
    out["launches"]["faults_router"] = counts
    c = reg.snapshot()["counters"]
    failed = [r["replica"] for r in router.replica_states()
              if r["state"] == router_lib.FAILED]
    check(not errors and len(failed) == 1
          and c.get("serve.router.replica_failures") == 1
          and c.get("serve.router.retried_bins", 0) >= 1
          and c.get("serve.router.request_failures", 0) == 0,
          f"faults (e): errors {errors[:2]}, failed {failed}, counters "
          f"{ {k: v for k, v in c.items() if 'fail' in k or 'retr' in k} }")
    check(wrong == 0, f"faults (e): {wrong} routed segments differ from "
          "their replica engine's rows")
    log(f"faults: (e) serve.router.dispatch error on call 2 over 2 "
        f"replicas: replica {failed} failed, serve.router.retried_bins "
        f"{c.get('serve.router.retried_bins')}, {len(futs)} requests of 8 "
        f"rows, none failed, every row bitwise the engine's; counts "
        f"{plan.counts()}; launches {counts}")


def faults_host(torch, serve: dict, root: Path, out: dict) -> None:
    """(f) ``host.decode`` through ``predict.main`` on the eight 299-px
    fixture photos, one host worker, the plan armed before the call (an
    ``obs.fault_plan`` would be armed again, with fresh counts, by the
    engine predict builds after its host stage, as in the reference):
    retried with ``--max_retries 2``, a reject with ``--max_retries 0
    --strict``."""
    import numpy as np

    from jama16_retina_tpu_torch.obs import faultinject
    from jama16_retina_tpu_torch.obs import registry as obs_registry
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.serve import host

    photos = [str(FIXTURES / f"fundus299_{i}.jpg") for i in range(8)]
    plan = {"host.decode": {"kind": "error", "error": "OSError",
                            "on_calls": [2]}}
    base = [f"--checkpoint_dir={Path(serve['dirs'][0]).parent}",
            f"--images={FIXTURES}/fundus299_*", "--config=eyepacs_binary",
            "--batch_size=8", "--host_workers=1",
            "--set", "serve.fused_preprocess=true"]
    runs = {}
    for name, extra in (("clean", []),
                        ("retried", ["--max_retries=2", "--strict"]),
                        ("strict", ["--max_retries=0", "--strict"])):
        prev = fresh_registry()
        try:
            armed = (faultinject.plan_from_spec(plan) if name != "clean"
                     else None)
            faultinject.arm(armed)
            torch.cuda.synchronize()
            reset_launch_counts()
            code, rows = predict_rows(base + extra)
            counts = launch_counts()
            faultinject.disarm()
            retried = process_counter("serve.input_retried")
        finally:
            obs_registry.set_default_registry(prev)
        out["launches"][f"faults_host_{name}"] = counts
        runs[name] = (code, rows, retried, armed and armed.counts(), counts)
    code, rows, _, _, counts = runs["clean"]
    scored = [r for r in rows if "error" not in r]
    check(code == 0 and len(scored) == 8, f"faults (f): clean run {rows}")
    code, rows, retried, pc, counts = runs["retried"]
    check(code == 0 and len(rows) == 8 and retried == 1
          and [r.get("retried", False) for r in rows].count(True) == 1
          and rows[1].get("retried") is True
          and [{k: v for k, v in r.items() if k != "retried"}
               for r in rows] == scored
          and counts["fused_serve_preprocess"] == 1
          and pc == {"host.decode": {"calls": 9, "fires": 1}},
          f"faults (f): --max_retries 2: exit {code}, serve.input_retried "
          f"{retried}, rows {rows}, launches {counts}")
    log(f"faults: (f) predict --max_retries 2 --strict under host.decode "
        f"OSError on call 2: exit {code}, {len(rows)} rows, one "
        f"\"retried\": true ({Path(rows[1]['image']).name}), "
        f"serve.input_retried {retried}, rows equal to the unarmed run's; "
        f"counts {pc}; launches {counts}")
    code, rows, retried, pc, counts = runs["strict"]
    errs = [r for r in rows if "error" in r]
    check(code == 2 and len(rows) == 8 and len(errs) == 1
          and errs[0]["error"].startswith("unreadable")
          and errs[0]["image"] == photos[1] and retried == 0
          and pc == {"host.decode": {"calls": 8, "fires": 1}},
          f"faults (f): --max_retries 0 --strict: exit {code}, rows {rows}")
    log(f"faults: (f) predict --max_retries 0 --strict: exit {code}, "
        f"{len(rows) - 1} scored rows and the reject {errs[0]}; counts "
        f"{pc}; launches {counts}")
    faultinject.arm(plan)
    pre = host.preprocess_paths(photos, 299, workers=1, registry=Registry(),
                                max_retries=2)
    faultinject.disarm()
    clean = host.preprocess_paths(photos, 299, workers=1,
                                  registry=Registry())
    check(pre.retried == [photos[1]] and np.array_equal(pre.images,
                                                        clean.images),
          "faults (f): the retried canvases differ from the unarmed ones")
    log("faults: (f) the host stage's canvases under the plan bitwise the "
        "unarmed ones")


def faults_integrity(torch, smi: str, router: dict, root: Path,
                     out: dict) -> None:
    """(g) ``integrity.write`` bitflip on phase 13e's serve-policy save:
    ``load_policy`` refuses the file; a checksum refusal counts
    ``integrity.corrupt`` and fires ``artifact_corrupt`` at the next
    flush. The damaged file is deleted."""
    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.integrity.artifact import ArtifactCorrupt
    from jama16_retina_tpu_torch.obs import alerts as obs_alerts
    from jama16_retina_tpu_torch.obs import export as obs_export
    from jama16_retina_tpu_torch.obs import faultinject
    from jama16_retina_tpu_torch.obs import registry as obs_registry
    from jama16_retina_tpu_torch.serve import policy as policy_lib
    from jama16_retina_tpu_torch.utils.logging import read_jsonl

    cfg = configs.override(configs.get_config("eyepacs_binary"), [
        "model.compute_dtype=float32", "serve.fused_preprocess=true",
        "serve.bucket_sizes=" + ",".join(map(str, ROUTER_BUCKETS)),
        "serve.max_batch=64", "serve.router_tick_ms=1"])
    pol = policy_lib.derive_policy(
        router["policy"]["frontier"],
        policy_lib.policy_fingerprint(cfg, n_devices=1),
        source={"sweep": "chip_smoke.py phase 13e", "card": smi})
    check(pol.payload() == router["policy"]["policy"],
          "faults (g): the re-derived policy is not phase 13e's")
    path = root / "serve_policy.json"
    wd = root / "integrity_obs"
    prev = fresh_registry()
    try:
        # rate() needs the counter in the flush before the detection.
        counter = obs_registry.default_registry().counter("integrity.corrupt")
        snap = obs_export.Snapshotter(workdir=str(wd), every_s=0)
        snap.alerts = obs_alerts.manager_for(cfg, str(wd))
        snap.flush()
        plan = faultinject.plan_from_spec({"integrity.write": {
            "kind": "bitflip", "on_calls": [1]}})
        faultinject.arm(plan)
        policy_lib.save_policy(str(path), pol)
        faultinject.disarm()
        try:
            policy_lib.load_policy(str(path))
            refused = None
        except (ArtifactCorrupt, policy_lib.PolicyStale) as e:
            refused = e
        corrupt = counter.value
        time.sleep(0.01)
        snap.close()
    finally:
        obs_registry.set_default_registry(prev)
        path.unlink(missing_ok=True)
    alerts = [r["reason"] for r in read_jsonl(str(wd / "metrics.jsonl"))
              if r["kind"] == "alert" and r["state"] == "firing"]
    check(refused is not None, "faults (g): the damaged policy loaded")
    if isinstance(refused, ArtifactCorrupt):
        check(corrupt == 1 and alerts == ["artifact_corrupt"],
              f"faults (g): integrity.corrupt {corrupt}, alerts {alerts}")
    else:
        check(corrupt == 0 and alerts == [],
              f"faults (g): integrity.corrupt {corrupt}, alerts {alerts}")
    check(not path.exists(), "faults (g): the damaged policy was left")
    log(f"faults: (g) integrity.write bitflip on phase 13e's policy save: "
        f"load_policy refused it with {type(refused).__name__} "
        f"({str(refused)[:120]}); integrity.corrupt {corrupt}, firing "
        f"alerts {alerts}; counts {plan.counts()}; the damaged file "
        "deleted")
    shutil.rmtree(wd, ignore_errors=True)


def phase_faults(torch, seed: int, smi: str, serve: dict, router: dict,
                 data: Path) -> dict:
    """Fault injection and bounded retries at full width (phase 16 of the
    docstring), on phase 6's splits and phase 4's members."""
    t_phase = time.perf_counter()
    root = SCRATCH / "faults"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = {"launches": {}, "wall_s": {}}
    torch.cuda.empty_cache()
    drills = (
        ("a", lambda: faults_read(torch, seed, data, root, out)),
        ("b", lambda: faults_step_and_restore(torch, seed, data, root, out)),
        ("c", lambda: faults_kill9(torch, seed, data, root, out)),
        ("d", lambda: faults_dispatch(torch, seed, serve, out)),
        ("e", lambda: faults_router(torch, seed, serve, out)),
        ("f", lambda: faults_host(torch, serve, root, out)),
        ("g", lambda: faults_integrity(torch, smi, router, root, out)))
    for name, fn in drills:
        with FaultDrill(name, out):
            fn()
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    log(f"times: phase 16 (faults) wall {wall:.1f} s; by drill "
        f"{ {k: round(v, 1) for k, v in out['wall_s'].items()} } ({smi})")
    return out


# Phase 17: the preprocess runners.
PRE_FIXTURES = ROOT / "tests" / "data" / "preprocess"
# What predict --images reads in (e): the Messidor-size TIFF, two small
# TIFF variants, four JPEG photos, and a TIFF variant the port refuses.
PRE_PREDICT = ("messidor_0.tif", "t_be_lzw_pred.tif",
               "t_tiles_deflate_pred.tif", "eyepacs_0.jpg", "eyepacs_1.jpg",
               "eyepacs_2.jpg", "eyepacs_3.jpg")
PRE_REFUSED = "r_cmyk.tif"
ENCODE_REPS = 20


def pre_manifest() -> dict:
    with open(PRE_FIXTURES / "manifest.json") as f:
        return json.load(f)


def build_runner_dir(spec: dict, out: Path) -> Path:
    """A runner spec's photo directory (``out/images``: each name a copy
    of its committed photo) and labels CSV; returns the CSV's path."""
    images = out / "images"
    images.mkdir(parents=True, exist_ok=True)
    for name, src, _ in spec["entries"]:
        if src is not None:
            shutil.copyfile(ROOT / "tests" / "data" / src, images / name)
    labels = out / spec["labels_csv"]
    labels.write_text(spec["csv"])
    return labels


def file_digests(d: Path) -> dict:
    import hashlib

    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.iterdir())}


def pre_codec(smi: str) -> dict:
    """(a) The encoder and the TIFF decoder on this machine's host against
    the manifest's OpenCV digests; (f) the encoder's time per canvas."""
    import hashlib

    from jama16_retina_tpu_torch.data import imdecode, jpeg
    from jama16_retina_tpu_torch.preprocess import fundus

    manifest = pre_manifest()
    encoded = 0
    canvas = None
    for key, want in sorted(manifest["encode"].items()):
        src, _, what = key.partition(":")
        rgb = imdecode.imdecode((ROOT / "tests" / "data" / src).read_bytes())
        check(rgb is not None, f"{src} did not decode")
        if what:
            rgb = canvas = fundus.resize_and_center_fundus(rgb, diameter=299)
        got = hashlib.sha256(jpeg.encode_jpeg(rgb)).hexdigest()
        check(got == want, f"encode_jpeg({key}) is not cv2.imencode's bytes")
        encoded += 1
    decoded = refused = 0
    for name, entry in sorted(manifest["files"].items()):
        data = (PRE_FIXTURES / name).read_bytes()
        check(sha256(data) == entry["sha256"], f"fixture {name} changed")
        if not name.endswith(".tif"):
            continue
        rgb, why = imdecode.read_image(data)
        if "refused" in entry:
            check(rgb is None and "item 14" in (why or "")
                  and entry["refused"] in why, f"{name}: {why}")
            refused += 1
        else:
            check(rgb is not None and sha256(rgb) == entry["cv2_rgb"],
                  f"{name}: the decode differs from OpenCV's ({why})")
            decoded += 1
    jpeg.encode_jpeg(canvas)
    t0 = time.perf_counter()
    for _ in range(ENCODE_REPS):
        jpeg.encode_jpeg(canvas)
    ms = 1e3 * (time.perf_counter() - t0) / ENCODE_REPS
    log(f"preprocess: {encoded} encodings bitwise cv2.imencode's (quality "
        f"92, photos and their 299-px canvases), {decoded} TIFF decodes "
        f"bitwise OpenCV's, {refused} TIFF variants refused naming item 14")
    log(f"times: encode_jpeg of a 299-px canvas {ms:.3f} ms on the host "
        f"(mean of {ENCODE_REPS} calls) ({smi})")
    return {"encoded": encoded, "decoded": decoded, "refused": refused,
            "encode_ms": ms}


def pre_runner(spec_name: str, root: Path, smi: str,
               extra: "dict | None" = None) -> dict:
    """(b), (c) ``python -m jama16_retina_tpu_torch.<cli>`` on the spec's
    directory for each of the manifest's runs (and ``extra``: another
    worker count for a run, whose files must be that run's): the printed
    report character for character and every file's sha256 the
    reference's. Returns each run's output directory and photos/s."""
    spec = pre_manifest()["runners"][spec_name]
    labels = build_runner_dir(spec, root / spec_name)
    runs = {r: (r, w["argv"]) for r, w in spec["runs"].items()}
    runs.update(extra or {})
    out = {}
    for run, (like, argv) in runs.items():
        want = spec["runs"][like]
        dest = root / spec_name / run
        cmd = [sys.executable, "-m", f"jama16_retina_tpu_torch.{spec['cli']}",
               f"--data_dir={root / spec_name / 'images'}",
               f"--labels_csv={labels}", f"--output_dir={dest}", *argv]
        t0 = time.perf_counter()
        done = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        check(done.returncode == 0,
              f"{spec['cli']} {argv} exited {done.returncode}: "
              f"{done.stderr[-2000:]}")
        check(done.stdout == want["stdout"],
              f"{spec['cli']} {argv} printed {done.stdout}, the reference "
              f"{want['stdout']}")
        got = file_digests(dest)
        bad = sorted(n for n in set(got) | set(want["files"])
                     if got.get(n) != want["files"].get(n))
        check(not bad, f"{spec['cli']} {argv}: files differ from the "
                       f"reference's: {bad}")
        rate = len(spec["entries"]) / wall
        out[run] = {"dir": dest, "photos_per_s": rate, "wall_s": wall}
        log(f"preprocess: {spec['cli']} {' '.join(argv)}: report and "
            f"{len(got)} files bitwise the reference's; "
            f"{len(spec['entries'])} photos in {wall:.2f} s, {rate:.1f} "
            f"photos/s on the host, process start included ({smi})")
    return out


def pre_predict(torch, serve: dict, root: Path, smi: str, out: dict) -> None:
    """(e) ``predict.main`` (fused preprocess, float32) on TIFF and JPEG
    photos and a refused TIFF, against phase 4's k=2 members."""
    import numpy as np

    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.obs import registry as obs_registry
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.serve import host
    from jama16_retina_tpu_torch.serve.engine import ServingEngine

    images = root / "predict"
    images.mkdir(parents=True)
    for name in (*PRE_PREDICT, PRE_REFUSED):
        shutil.copy(PRE_FIXTURES / name, images / name)
    reg = obs_registry.default_registry()
    m = reg._metrics.get("serve.input_rejected.decode_error")
    before = 0.0 if m is None else m.value
    sets = ["serve.fused_preprocess=true", "model.compute_dtype=float32"]
    argv = [f"--checkpoint_dir={Path(serve['dirs'][0]).parent}",
            f"--images={images}", "--config=eyepacs_binary",
            f"--batch_size={PREDICT_BATCH}", "--threshold=0.5",
            *[a for s in sets for a in ("--set", s)]]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    code, rows = predict_rows(argv)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    out["launches"]["preprocess_predict"] = counts
    m = reg._metrics.get("serve.input_rejected.decode_error")
    rejected = (0.0 if m is None else m.value) - before
    errors = {Path(r["image"]).name: r["error"] for r in rows if "error" in r}
    scored = [r for r in rows if "error" not in r]
    chunks = -(-len(PRE_PREDICT) // PREDICT_BATCH)
    log(f"preprocess: predict --images on {len(PRE_PREDICT)} TIFF and JPEG "
        f"photos and {PRE_REFUSED}: exit {code}, {len(scored)} rows, "
        f"skipped {errors}; launches {counts}; {wall:.2f} s")
    check(code == 0 and len(scored) == len(PRE_PREDICT),
          f"predict rows {rows}")
    check(list(errors) == [PRE_REFUSED]
          and "item 14" in errors[PRE_REFUSED] and rejected == 1,
          f"predict skipped {errors}, decode_error moved by {rejected}")
    check(counts["fused_serve_preprocess"] == chunks
          and sum(counts.values()) == chunks,
          f"predict launched {counts}, want B4 once per chunk ({chunks})")
    files = pre_manifest()["files"]
    paths = [str(images / n) for n in sorted(PRE_PREDICT)]
    pre = host.preprocess_paths(paths, 299, registry=Registry())
    check([Path(p).name for p in pre.kept]
          == [Path(r["image"]).name for r in scored],
          "predict scored other rows than the host stage keeps")
    bad = [Path(p).name for p, c in zip(pre.kept, pre.images)
           if sha256(c) != files[Path(p).name]["canvas299"]]
    check(not bad, f"canvases differ from the manifest: {bad}")
    cfg = configs.override(configs.get_config("eyepacs_binary"), sets + [
        f"serve.max_batch={PREDICT_BATCH}",
        f"serve.bucket_sizes={PREDICT_BATCH}"])
    want = ServingEngine(cfg, serve["dirs"], device="cpu",
                         registry=Registry()).probs(pre.images)
    probs = np.array([r["prob"] for r in scored])
    dev = float(np.max(np.abs(probs - want)))
    log(f"preprocess: predict --images: {len(scored)} canvases bitwise the "
        f"manifest's, card rows vs the CPU engine max |prob diff| "
        f"{dev:.3e} (atol 1e-4, rows at 6 decimals, TF32 off)")
    check(bool(np.all(np.isfinite(probs))) and dev <= 1e-4,
          f"predict rows differ from the CPU engine by {dev}")


def phase_preprocess(torch, seed: int, smi: str, serve: dict) -> dict:
    """The preprocess runners on the host, then a fit from what they
    wrote and predict --images on TIFF photos (phase 17 of the
    docstring)."""
    t_phase = time.perf_counter()
    root = SCRATCH / "preprocess"
    shutil.rmtree(root, ignore_errors=True)
    out = {"launches": {}}
    out["codec"] = pre_codec(smi)
    eyepacs = pre_runner("eyepacs", root, smi, extra={
        "jpeg_workers0": ("jpeg_workers2", ["--workers=0"])})
    messidor = pre_runner("messidor", root, smi)
    out["runners"] = {f"{k}_{r}": v["photos_per_s"] for k, runs in (
        ("eyepacs", eyepacs), ("messidor", messidor))
        for r, v in runs.items()}
    jdir = eyepacs["jpeg_workers2"]["dir"]

    # (d) eyepacs_binary from the runner's JPEG splits, evals at 4 and 8;
    # then its best step on the Messidor split, thresholds from val.
    cfg = fit_config(FIT_STEPS, root / "fit", seed)
    res, counts, recs = fit_run(torch, cfg, jdir)
    log(f"preprocess: fit from the runner's JPEG records: {res}; launches "
        f"{counts}")
    out["launches"]["preprocess_fit"] = counts
    check(counts["fused_color_jitter"] == FIT_STEPS
          and counts["fused_normalize_color_jitter"] == 0
          and counts["fused_adamw_update"] == 0,
          f"the fit launched {counts}, want B1 = {FIT_STEPS}")
    evals = [r for r in recs if r["kind"] == "eval"]
    check([r["step"] for r in evals] == [4, 8]
          and all(0 <= r["val_auc"] <= 1 for r in evals),
          f"the fit's evals {evals}")
    n_test = json.loads(pre_manifest()["runners"]["messidor"]["runs"][
        "jpeg_workers2"]["stdout"])["test"]["written"]
    out["eval_card_vs_cpu"] = evaluate_card_and_cpu(
        cfg, messidor["jpeg_workers2"]["dir"], root / "fit", root,
        "preprocess", threshold_dir=jdir, n_test=n_test)
    # (e) predict --images on TIFF and JPEG photos.
    pre_predict(torch, serve, root, smi, out)
    shutil.rmtree(root, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"times: phase 17 (preprocess) wall {out['wall_s']:.1f} s ({smi})")
    return out



HBM_RECORDS = 4096
HBM_WRITERS = 8
HBM_VAL = 32
HBM_STEPS = 8
HBM_FUSED_STEPS = 4
HBM_CUT_CALL = 5
HBM_GATHER_REPS = 100
HBM_POISON_CALL = 7
HBM_JPEG_LOAD = FIXTURES / "hbm_load.json"


class HbmPart:
    """One part of phase 18 (or, with ``prefix``, of another phase): a
    start line, and an end line with its wall time, so that a failed
    run's log names the part."""

    def __init__(self, name: str, what: str, out: dict,
                 prefix: str = "hbm"):
        self.name, self.what, self.out = name, what, out
        self.prefix = prefix

    def __enter__(self):
        log(f"{self.prefix}: ({self.name}) start: {self.what}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *_):
        wall = time.perf_counter() - self.t0
        self.out["wall_s"][self.name] = wall
        if exc_type is None:
            log(f"{self.prefix}: ({self.name}) end: {wall:.1f} s")
        return False


_HBM_WRITER = r"""
import sys
from jama16_retina_tpu_torch.data import tfrecord
tfrecord.write_synthetic_split(sys.argv[1], "train", int(sys.argv[2]), 299,
                               num_shards=2, seed=int(sys.argv[3]),
                               encoding="raw")
"""


def write_hbm_train(data: Path) -> float:
    """The 4,096-record raw 299-px train split, written by ``HBM_WRITERS``
    processes at once, each ``write_synthetic_split`` of its share (seeds
    1-8) into 2 shards, renamed into one split of 16; -> seconds."""
    t0 = time.perf_counter()
    per = HBM_RECORDS // HBM_WRITERS
    parts = [data / f"part{w}" for w in range(HBM_WRITERS)]
    procs = [subprocess.Popen([sys.executable, "-c", _HBM_WRITER, str(p),
                               str(per), str(w + 1)], cwd=ROOT)
             for w, p in enumerate(parts)]
    codes = [p.wait() for p in procs]
    check(codes == [0] * HBM_WRITERS, f"hbm: split writers exited {codes}")
    shards = 2 * HBM_WRITERS
    for w, part in enumerate(parts):
        for j, f in enumerate(sorted(part.glob("train-*.tfrecord"))):
            f.rename(data / f"train-{2 * w + j:05d}-of-{shards:05d}.tfrecord")
        part.rmdir()
    return time.perf_counter() - t0


def hbm_reference_batch(images, grades, seed: int, step: int):
    """The host's numpy gather of batch ``step``: the rows of the epoch
    permutation's slice."""
    from jama16_retina_tpu_torch.data import threefry

    n = len(images)
    epoch, pos = divmod(step, n // TRAIN_BATCH)
    idx = threefry.epoch_permutation(seed, epoch, n)[
        pos * TRAIN_BATCH:(pos + 1) * TRAIN_BATCH]
    return images[idx], grades[idx]


def hbm_batches_match(torch, stream, images, grades, seed: int,
                      steps) -> int:
    n = 0
    for step in steps:
        got = next(stream)
        want_i, want_g = hbm_reference_batch(images, grades, seed, step)
        check(got["image"].device.type == "cuda"
              and torch.equal(got["image"].cpu(), torch.from_numpy(want_i))
              and torch.equal(got["grade"].cpu(), torch.from_numpy(want_g)),
              f"hbm: batch {step} differs from the host reference")
        n += 1
    return n


def hbm_load_and_upload(torch, data: Path, smi: str, out: dict):
    """(a) The split decoded at 1 and at the automatic worker count, and
    uploaded alone -> (images, grades)."""
    import numpy as np

    from jama16_retina_tpu_torch.data import grain_pipeline, hbm_pipeline

    loads = []
    for workers in (1, 0):
        resolved = grain_pipeline.resolve_decode_workers(workers)
        t0 = time.perf_counter()
        loads.append(hbm_pipeline.load_split_numpy(
            str(data), "train", 299, workers=resolved))
        dt = time.perf_counter() - t0
        out["decode_rows_per_s"][str(resolved)] = HBM_RECORDS / dt
        log(f"hbm: (a) load_split_numpy at decode_workers={workers} "
            f"({resolved} thread(s)): {HBM_RECORDS} raw 299-px records in "
            f"{dt:.3f} s, {HBM_RECORDS / dt:.1f} rows/s on the host ({smi})")
    (images, grades), (images2, grades2) = loads
    check(np.array_equal(images, images2) and np.array_equal(grades, grades2),
          "hbm: (a) the split decoded at 1 and at the automatic worker "
          "count differ")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    get_batch = hbm_pipeline.make_batch_fn(images, grades, TRAIN_BATCH, 0,
                                           device="cuda")
    torch.cuda.synchronize()
    upload_ms = 1e3 * (time.perf_counter() - t0)
    took = torch.cuda.memory_allocated() - before
    want = HBM_RECORDS * hbm_pipeline.row_bytes(299)
    check(took >= want, f"hbm: (a) the upload took {took} card bytes, "
          f"want at least {want}")
    get_batch(0)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for step in range(1, 1 + HBM_GATHER_REPS):
        get_batch(step)
    end.record()
    end.synchronize()
    gather_ms = start.elapsed_time(end) / HBM_GATHER_REPS
    del get_batch
    torch.cuda.empty_cache()
    out.update(upload_ms=upload_ms, card_bytes=took, gather_ms=gather_ms)
    log(f"hbm: (a) upload of {images.nbytes + grades.nbytes} bytes "
        f"{upload_ms:.1f} ms ({(images.nbytes + grades.nbytes) / upload_ms / 1e6:.2f} "
        f"GB/s, pageable host memory); card bytes "
        f"{took} (memory_allocated before {before}); gather {gather_ms:.4f} "
        f"ms a batch of {TRAIN_BATCH} (mean of {HBM_GATHER_REPS} within an "
        f"epoch, CUDA events) ({smi})")
    return images, grades


def state_digest(wd: Path, step: int) -> str:
    """sha256 over a checkpoint's leaves, by name."""
    import hashlib

    import numpy as np

    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

    flat = ckpt_lib.Checkpointer(str(wd)).restore(step)
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(np.ascontiguousarray(flat[k]).tobytes())
    return h.hexdigest()


def cached_val_eval(torch, cfg, wd: Path, data: Path, step_at: int,
                    what: str) -> dict:
    """The val eval of a fit's step-``step_at`` state streamed, filling
    the card cache and from it, and streamed again: bitwise, each one's
    ms -> {eval_first_ms, eval_fill_ms, eval_cached_ms,
    eval_streamed_ms}."""
    import numpy as np

    from jama16_retina_tpu_torch import models, train_lib, trainer
    from jama16_retina_tpu_torch.models import init
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

    flat = ckpt_lib.Checkpointer(str(wd)).restore(step_at)
    state = train_lib.load_state_flat(train_lib.create_state(
        cfg, init.init_flax_default(models.build(cfg.model),
                                    cfg.train.seed), "cuda"), flat)
    step = train_lib.make_eval_step(cfg, state, "cuda")

    def fn(images):
        return step(images)[None]

    def timed(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = trainer.predict_split(cfg, fn, str(data), "val", **kw)
        return res, 1e3 * (time.perf_counter() - t0)

    with torch.no_grad():
        streamed, stream_ms = timed()
        cache = trainer._eval_cache_for(cfg, str(data), "val",
                                        device="cuda")
        check(cache == [], f"{what}: the val cache was refused: {cache}")
        filled, fill_ms = timed(cache=cache, device="cuda")
        cached, cached_ms = timed(cache=cache, device="cuda")
        again, again_ms = timed()
    for got in (filled, cached, again):
        check(all(np.array_equal(g, w) for g, w in zip(got, streamed)),
              f"{what}: a cached val eval differs from the streamed one")
    del state, step, cache
    torch.cuda.empty_cache()
    return {"eval_first_ms": stream_ms, "eval_fill_ms": fill_ms,
            "eval_cached_ms": cached_ms, "eval_streamed_ms": again_ms}


def hbm_fits(torch, seed: int, data: Path, root: Path, smi: str,
             out: dict) -> None:
    """(d) Eight preset steps with evals at 4 and 8 and the val cache; the
    same run cut at step 5 and resumed; four fused steps; the cached val
    eval against the streamed one."""
    from jama16_retina_tpu_torch import trainer
    from jama16_retina_tpu_torch.obs import faultinject

    digest = state_digest
    hbm = ("data.loader=hbm",)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        cfg_a = fit_config(HBM_STEPS, root / "a", seed, *hbm)
        res_a, counts_a, recs_a = fit_run(torch, cfg_a, data)
        out["launches"]["hbm_fit"] = counts_a
        check(counts_a == {"fused_color_jitter": HBM_STEPS,
                           "fused_normalize_color_jitter": 0,
                           "fused_adamw_update": 0,
                           "fused_serve_preprocess": 0},
              f"hbm: (d) the preset fit launched {counts_a}, want B1 = "
              f"{HBM_STEPS}")
        evals = [r for r in recs_a if r["kind"] == "eval"]
        check([r["step"] for r in evals] == [4, 8]
              and all(0 <= r["val_auc"] <= 1 for r in evals),
              f"hbm: (d) the fit's evals {evals}")
        train_a = {r["step"]: r for r in recs_a if r["kind"] == "train"}
        step_ms = statistics.median(
            1e3 * r["window_sec"] for s, r in train_a.items()
            if s > 1 and r["pause_sec"] == 0 and r["save_sec"] == 0)
        input_ms = statistics.median(
            1e3 * r["input_wait_sec"] for s, r in train_a.items() if s > 1)
        out.update(step_ms=step_ms, input_wait_ms=input_ms,
                   first_input_s=train_a[1]["input_wait_sec"])
        log(f"hbm: (d) {HBM_STEPS}-step preset fit from the card-resident "
            f"split: {res_a}; launches {counts_a}; step median "
            f"{step_ms:.3f} ms (input wait {input_ms:.3f} ms; step 1's "
            f"input wait, the decode and upload, "
            f"{train_a[1]['input_wait_sec']:.2f} s) ({smi})")

        cut = {"trainer.step": {"kind": "error", "error": "RuntimeError",
                                "on_calls": [HBM_CUT_CALL],
                                "message": "hbm cut"}}
        cfg_b = fit_config(HBM_STEPS, root / "b", seed, *hbm,
                           fault_spec(cut))
        torch.cuda.synchronize()
        reset_launch_counts()
        try:
            trainer.fit(cfg_b, str(data), str(root / "b"), device="cuda")
            raised = None
        except RuntimeError as e:
            raised = str(e)
        counts_b1 = launch_counts()
        faultinject.disarm()
        check(raised is not None and "hbm cut" in raised
              and counts_b1["fused_color_jitter"] == HBM_CUT_CALL - 1,
              f"hbm: (d) the cut run raised {raised!r}, launched {counts_b1}")
        _, counts_b, recs_b = fit_run(torch, fit_config(
            HBM_STEPS, root / "b", seed, *hbm, "train.resume=true"), data)
        out["launches"]["hbm_fit_cut"] = counts_b1
        out["launches"]["hbm_fit_resume"] = counts_b
        check([r["step"] for r in recs_b if r["kind"] == "resume"] == [4]
              and counts_b["fused_color_jitter"] == HBM_STEPS - 4,
              f"hbm: (d) the resume launched {counts_b}")
        da, db = digest(root / "a", HBM_STEPS), digest(root / "b", HBM_STEPS)
        check(da == db, f"hbm: (d) the resumed run's step-{HBM_STEPS} state "
              f"{db[:16]} differs from the uninterrupted run's {da[:16]}")
        log(f"hbm: (d) the run cut by trainer.step at call {HBM_CUT_CALL} "
            f"(launches {counts_b1}) and resumed from 4 (launches "
            f"{counts_b}): the step-{HBM_STEPS} state digest {da[:16]} "
            "equals the uninterrupted run's (cuDNN deterministic)")

        cfg_f = fit_config(HBM_FUSED_STEPS, root / "f", seed, *hbm,
                           "train.use_pallas_fused=true")
        res_f, counts_f, _ = fit_run(torch, cfg_f, data)
        out["launches"]["hbm_fit_fused"] = counts_f
        check(counts_f == {"fused_color_jitter": 0,
                           "fused_normalize_color_jitter": HBM_FUSED_STEPS,
                           "fused_adamw_update": HBM_FUSED_STEPS,
                           "fused_serve_preprocess": 0},
              f"hbm: (d) the fused fit launched {counts_f}, want B2 = B3 = "
              f"{HBM_FUSED_STEPS}")
        log(f"hbm: (d) {HBM_FUSED_STEPS}-step fused fit: {res_f}; launches "
            f"{counts_f}")
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags

    ev = cached_val_eval(torch, cfg_a, root / "a", data, HBM_STEPS,
                         "hbm: (d)")
    out.update(ev)
    log(f"hbm: (d) val eval of {HBM_VAL} images from the step-{HBM_STEPS} "
        f"state: streamed {ev['eval_first_ms']:.1f} ms (the first eval of "
        f"this engine), filling the cache {ev['eval_fill_ms']:.1f} ms, from "
        f"the cache {ev['eval_cached_ms']:.1f} ms, streamed again "
        f"{ev['eval_streamed_ms']:.1f} ms; cached probabilities bitwise the "
        f"streamed ones ({smi})")


def hbm_poison(torch, data: Path, root: Path, images, grades,
               out: dict) -> None:
    """(e) A ``tfrecord.read`` corrupt plan on one call at one decode
    thread: one ``decode_error``, the substitute rows resident, the
    ``data_quarantine`` alert; without the quarantine the load raises."""
    import numpy as np

    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.data import hbm_pipeline
    from jama16_retina_tpu_torch.obs import alerts as obs_alerts
    from jama16_retina_tpu_torch.obs import export as obs_export
    from jama16_retina_tpu_torch.obs import faultinject
    from jama16_retina_tpu_torch.obs import registry as obs_registry
    from jama16_retina_tpu_torch.utils.logging import read_jsonl

    plan_spec = {"tfrecord.read": {"kind": "corrupt",
                                   "on_calls": [HBM_POISON_CALL]}}
    cfg = configs.override(configs.get_config("eyepacs_binary"), [
        "data.loader=hbm", "data.decode_workers=1",
        f"data.batch_size={TRAIN_BATCH}", "obs.quarantine_alert_per_s=0.001"])
    bad = HBM_POISON_CALL - 1
    want_i, want_g = images.copy(), grades.copy()
    want_i[bad], want_g[bad] = images[bad + 1], grades[bad + 1]
    wd = root / "poison_obs"
    prev = fresh_registry()
    try:
        reg = obs_registry.default_registry()
        # rate() needs the counter in the flush before the quarantine.
        reg.counter("data.quarantined")
        snap = obs_export.Snapshotter(workdir=str(wd), every_s=0)
        snap.alerts = obs_alerts.manager_for(cfg, str(wd))
        snap.flush()
        plan = faultinject.plan_from_spec(plan_spec)
        faultinject.arm(plan)
        stream = hbm_pipeline.train_batches(str(data), "train", cfg.data,
                                            299, seed=0, device="cuda")
        try:
            checked = hbm_batches_match(torch, stream, want_i, want_g, 0,
                                        range(HBM_RECORDS // TRAIN_BATCH))
        finally:
            stream.close()
            faultinject.disarm()
        counters = reg.snapshot()["counters"]
        time.sleep(0.01)
        snap.close()
    finally:
        obs_registry.set_default_registry(prev)
    alerts = [r["reason"] for r in read_jsonl(str(wd / "metrics.jsonl"))
              if r["kind"] == "alert" and r["state"] == "firing"]
    got = {k: counters.get(k, 0) for k in (
        "data.quarantined", "data.quarantined.decode_error",
        "data.quarantined.read_error")}
    check(got == {"data.quarantined": 1,
                  "data.quarantined.decode_error": 1,
                  "data.quarantined.read_error": 0},
          f"hbm: (e) quarantine counters {got}")
    check(alerts == ["data_quarantine"], f"hbm: (e) firing alerts {alerts}")
    log(f"hbm: (e) tfrecord.read corrupt on call {HBM_POISON_CALL} at one "
        f"decode thread: {got}; record {bad} replaced by record {bad + 1}, "
        f"and all {checked} batches of an epoch bitwise the host reference "
        f"with that substitute; firing alerts {alerts}; counts "
        f"{plan.counts()}")
    out["poison"] = got
    strict = configs.override(cfg, ["data.quarantine_bad_records=false"])
    faultinject.arm(faultinject.plan_from_spec(plan_spec))
    try:
        next(hbm_pipeline.train_batches(str(data), "train", strict.data,
                                        299, device="cuda"))
        raised = None
    except Exception as e:  # noqa: BLE001 - the check reads it
        raised = e
    finally:
        faultinject.disarm()
    check(raised is not None and not isinstance(raised, OSError),
          f"hbm: (e) without the quarantine the load raised {raised!r}")
    log(f"hbm: (e) data.quarantine_bad_records=false: the load raised "
        f"{type(raised).__name__}: {str(raised)[:80]}")
    shutil.rmtree(wd, ignore_errors=True)


def phase_hbm(torch, seed: int, smi: str) -> dict:
    """The card-resident ``hbm`` loader alone first, then a fit from it
    (phase 18 of the docstring)."""
    import numpy as np

    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.data import grain_pipeline, hbm_pipeline
    from jama16_retina_tpu_torch.data import tfrecord

    t_phase = time.perf_counter()
    root = SCRATCH / "hbm"
    shutil.rmtree(root, ignore_errors=True)
    data = root / "data"
    out = {"launches": {}, "wall_s": {}, "decode_rows_per_s": {}}
    with HbmPart("a", "decode and upload, alone", out):
        write_s = write_hbm_train(data)
        tfrecord.write_synthetic_split(str(data), "val", HBM_VAL, 299,
                                       num_shards=2, seed=2, encoding="raw")
        out["write_s"] = write_s
        log(f"hbm: (a) wrote {HBM_RECORDS} raw 299-px train records in "
            f"{2 * HBM_WRITERS} shards ({HBM_WRITERS} writer processes) in "
            f"{write_s:.1f} s ({HBM_RECORDS * hbm_pipeline.row_bytes(299)} "
            f"resident bytes) and {HBM_VAL} val ({smi})")
        images, grades = hbm_load_and_upload(torch, data, smi, out)
    with HbmPart("b", "batches across an epoch boundary", out):
        cfg = configs.override(configs.get_config("eyepacs_binary"), [
            "data.loader=hbm", f"data.batch_size={TRAIN_BATCH}"])
        per_epoch = HBM_RECORDS // TRAIN_BATCH
        for skip, steps in ((0, range(per_epoch + 2)),
                            (per_epoch + 2, range(per_epoch + 2,
                                                  per_epoch + 6))):
            stream = hbm_pipeline.train_batches(
                str(data), "train", cfg.data, 299, seed=seed,
                skip_batches=skip, device="cuda")
            try:
                n = hbm_batches_match(torch, stream, images, grades, seed,
                                      steps)
            finally:
                stream.close()
            torch.cuda.empty_cache()
            log(f"hbm: (b) skip {skip}: {n} batches (steps {steps.start}-"
                f"{steps.stop - 1}; {per_epoch} a epoch) bitwise the host "
                "reference")
    with HbmPart("c", "the JPEG records of the committed fixtures", out):
        with open(HBM_JPEG_LOAD) as f:
            want = json.load(f)
        jdir, _ = write_jpeg_splits(root / "jpeg")
        for split, entry in sorted(want.items()):
            rates = {}
            for workers in (1, 0):
                resolved = grain_pipeline.resolve_decode_workers(workers)
                t0 = time.perf_counter()
                j_images, j_grades = hbm_pipeline.load_split_numpy(
                    str(jdir), split, entry["image_size"], workers=resolved)
                rates[resolved] = entry["n"] / (time.perf_counter() - t0)
                check(sha256(j_images) == entry["images"]
                      and sha256(j_grades) == entry["grades"],
                      f"hbm: (c) {split} at {resolved} thread(s) differs "
                      "from the reference's recorded load")
            out["jpeg_rows_per_s"] = {str(k): v for k, v in rates.items()}
            log(f"hbm: (c) {split}: {entry['n']} JPEG records (the 317-px "
                "ones through INTER_LINEAR) bitwise the reference's "
                "load_split_numpy digests; rows/s by decode threads "
                f"{ {k: round(v, 1) for k, v in rates.items()} } ({smi})")
    with HbmPart("d", "fit from the resident split", out):
        hbm_fits(torch, seed, data, root, smi, out)
    with HbmPart("e", "poison drill", out):
        hbm_poison(torch, data, root, images, grades, out)
    del images, grades
    with HbmPart("f", "size gate", out):
        tiny = configs.override(configs.get_config("eyepacs_binary"), [
            "data.loader=hbm", "data.hbm_budget_bytes=1000000"])
        try:
            next(hbm_pipeline.train_batches(str(data), "val", tiny.data, 299,
                                            device="cuda"))
            refused = None
        except ValueError as e:
            refused = str(e)
        n_val = HBM_VAL * hbm_pipeline.row_bytes(299)
        want_msg = (
            f"val split ({n_val / 1e9:.1f} GB over 1 chip(s)) exceeds the "
            f"HBM-resident budget ({600000 / 1e9:.1f} GB/chip); use the "
            "tfdata or grain loader for datasets this size, or set "
            "data.hbm_budget_bytes if this chip's true memory limit is "
            "larger than the assumed base")
        check(refused == want_msg, f"hbm: (f) the gate said {refused!r}")
        log(f"hbm: (f) data.hbm_budget_bytes=1000000: refused with the "
            f"reference's message: {refused}")
    # Phase 19 reads the same splits and removes them.
    shutil.rmtree(root / "jpeg", ignore_errors=True)
    out["root"], out["data"] = root, data
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


TIERED_ROWS = HBM_RECORDS // 2
TIERED_BATCHES = 134
TIERED_SKIPS = (0, 130)
TIERED_THREADS = (1, 7)
TIERED_STREAMED = 10
TIERED_KNOBS = ("data.decode_workers=1", "data.stage_depth=1",
                "data.prefetch_batches=1")
TIERED_POISON_BATCHES = 4
TIERED_DAMAGED_SHARD = 8
TIERED_TRANSCODE = ("-m", "jama16_retina_tpu_torch.transcode_shards",
                    "--splits", "train", "--image_size", "299")


def tiered_budget() -> str:
    """The override that keeps half the split resident."""
    from jama16_retina_tpu_torch.data import hbm_pipeline

    return (f"data.tiered_resident_bytes="
            f"{TIERED_ROWS * hbm_pipeline.row_bytes(299)}")


def tiered_config(seed: int, *extra):
    """``eyepacs_binary`` at batch 32 with half the split resident."""
    from jama16_retina_tpu_torch import configs

    return configs.override(configs.get_config("eyepacs_binary"), [
        f"data.batch_size={TRAIN_BATCH}", f"train.seed={seed}",
        tiered_budget(), *extra])


def tiered_match(torch, stream, ref, n: int, what: str) -> int:
    """``n`` batches of a loader on the card bitwise those of ``ref``
    (host numpy batches, or card batches of another loader)."""
    for i in range(n):
        got, want = next(stream), next(ref)
        for k in ("image", "grade"):
            w = want[k]
            w = w.cpu() if isinstance(w, torch.Tensor) else torch.from_numpy(w)
            check(got[k].device.type == "cuda" and torch.equal(got[k].cpu(), w),
                  f"tiered: {what}: batch {i} ({k}) differs")
    return n


def decode_p50_ms(reg) -> float:
    h = reg.snapshot()["histograms"].get("data.tiered.decode_batch_s")
    return 1e3 * h["p50"] if h and h["p50"] is not None else float("nan")


def tiered_alone(torch, seed: int, data: Path, smi: str, out: dict) -> None:
    """(a) The plan, the resident upload alone, the streamed tier alone,
    then the batches at partial residency from two skips at 1 and 7
    decode threads, each bitwise ``host_reference_batches``."""
    from jama16_retina_tpu_torch.data import (grain_pipeline, hbm_pipeline,
                                              tfrecord, tiered_pipeline)

    plan = tiered_pipeline._TierPlan(HBM_RECORDS, TRAIN_BATCH, TIERED_ROWS,
                                     seed)
    got = (plan.steps, plan.res_pb, plan.str_pb, plan.n_res)
    check(got == (128, 16, 16, TIERED_ROWS), f"tiered: (a) the plan {got}")
    log(f"tiered: (a) plan for {HBM_RECORDS} records at batch {TRAIN_BATCH} "
        f"with {TIERED_ROWS} rows' budget: {plan.steps} steps an epoch, "
        f"{plan.res_pb} resident + {plan.str_pb} streamed rows a batch, "
        f"{plan.n_res} rows resident")
    index = grain_pipeline.TFRecordIndex(tfrecord.list_split(str(data),
                                                             "train"))
    decoder = grain_pipeline.ParallelDecoder(
        index, 299, workers=grain_pipeline.resolve_decode_workers(0))
    try:
        t0 = time.perf_counter()
        images, grades = decoder.decode_range(0, TIERED_ROWS)
        decode_s = time.perf_counter() - t0
    finally:
        decoder.close()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    resident = tiered_pipeline._place_resident(images, grades, "cuda")
    torch.cuda.synchronize()
    upload_ms = 1e3 * (time.perf_counter() - t0)
    took = torch.cuda.memory_allocated() - before
    want = TIERED_ROWS * hbm_pipeline.row_bytes(299)
    check(took >= want, f"tiered: (a) the resident upload took {took} card "
          f"bytes, want at least {want}")
    del resident, images, grades
    torch.cuda.empty_cache()
    out.update(resident_upload_ms=upload_ms, resident_bytes=took,
               resident_decode_s=decode_s)
    log(f"tiered: (a) resident tier alone: {TIERED_ROWS} rows decoded in "
        f"{decode_s:.3f} s, uploaded in {upload_ms:.1f} ms "
        f"({want / upload_ms / 1e6:.2f} GB/s, pageable host memory), "
        f"{took} card bytes ({smi})")
    cfg = tiered_config(seed)
    stream = tiered_pipeline.streamed_batches(str(data), "train", cfg.data,
                                              299, seed=seed, device="cuda")
    ref = tiered_pipeline.host_reference_batches(str(data), "train", cfg.data,
                                                 299, seed=seed)
    try:
        n = tiered_match(torch, stream, ref, TIERED_STREAMED, "(a) streamed")
    finally:
        stream.close()
        ref.close()
    log(f"tiered: (a) the streamed tier alone (residency 0): {n} batches of "
        f"{TRAIN_BATCH} host-decoded rows uploaded behind the consumer, "
        "bitwise the host reference")
    for workers in TIERED_THREADS:
        for skip in TIERED_SKIPS:
            prev = fresh_registry()
            try:
                c = tiered_config(seed, f"data.decode_workers={workers}")
                stream = tiered_pipeline.train_batches(
                    str(data), "train", c.data, 299, seed=seed,
                    skip_batches=skip, device="cuda")
                ref = tiered_pipeline.host_reference_batches(
                    str(data), "train", c.data, 299, seed=seed,
                    skip_batches=skip, capacity_rows=TIERED_ROWS)
                t0 = time.perf_counter()
                try:
                    n = tiered_match(torch, stream, ref, TIERED_BATCHES,
                                     f"(a) {workers} thread(s), skip {skip}")
                finally:
                    stream.close()
                    ref.close()
                wall = time.perf_counter() - t0
                p50 = decode_p50_ms(obs_registry_default())
            finally:
                restore_registry(prev)
            out["decode_batch_p50_ms"][f"{workers}/{skip}"] = p50
            log(f"tiered: (a) {workers} decode thread(s), skip {skip}: {n} "
                f"batches (steps {skip}-{skip + n - 1}, an epoch boundary "
                f"at {plan.steps * ((skip + n) // plan.steps)}) bitwise "
                f"host_reference_batches in {wall:.2f} s with the reference's "
                f"own decode; data.tiered.decode_batch_s p50 {p50:.3f} ms "
                f"for {plan.str_pb} streamed rows ({smi})")
            torch.cuda.empty_cache()


def obs_registry_default():
    from jama16_retina_tpu_torch.obs import registry as obs_registry

    return obs_registry.default_registry()


def restore_registry(prev) -> None:
    from jama16_retina_tpu_torch.obs import registry as obs_registry

    obs_registry.set_default_registry(prev)


def rawshard_alone(torch, seed: int, data: Path, smi: str,
                   out: dict) -> Path:
    """(b) The split transcoded by the CLI in a subprocess, twice (the
    second run reuses every shard), then the rawshard loader's batches
    bitwise the tiered loader's at (a)'s plan -> the shard dir."""
    from jama16_retina_tpu_torch.data import (grain_pipeline, rawshard,
                                              tiered_pipeline)

    shard_dir = Path(rawshard.default_shard_dir(str(data), 299))
    cmd = [sys.executable, *TIERED_TRANSCODE, "--data_dir", str(data)]
    runs = []
    for attempt in range(2):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        dt = time.perf_counter() - t0
        check(proc.returncode == 0, f"tiered: (b) the transcode exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        mtimes = {f.name: f.stat().st_mtime_ns
                  for f in sorted(shard_dir.glob("*.npy"))}
        runs.append((dt, line, mtimes))
    (dt, line, mtimes), (dt2, line2, mtimes2) = runs
    check(line == line2 and line["num_records"] == HBM_RECORDS
          and line["num_shards"] == HBM_RECORDS // 256
          and len(mtimes) == 2 * line["num_shards"],
          f"tiered: (b) the transcode printed {line} then {line2}")
    check(mtimes == mtimes2, "tiered: (b) the second transcode rewrote "
          "shards instead of reusing them")
    nbytes = sum(f.stat().st_size for f in shard_dir.glob("*.npy"))
    out.update(transcode_s=dt, transcode_again_s=dt2,
               transcode_rows_per_s=HBM_RECORDS / dt, shard_bytes=nbytes)
    log(f"tiered: (b) python -m jama16_retina_tpu_torch.transcode_shards: "
        f"{HBM_RECORDS} records into {line['num_shards']} shard pairs "
        f"({nbytes} bytes) in {dt:.2f} s ({HBM_RECORDS / dt:.1f} rows/s, "
        f"the subprocess's start included); again: every shard reused, "
        f"{dt2:.2f} s; printed {line} ({smi})")
    prev = fresh_registry()
    try:
        cfg = tiered_config(seed)
        stream = rawshard.train_batches(str(data), "train", cfg.data, 299,
                                        seed=seed, device="cuda")
        ref = tiered_pipeline.train_batches(str(data), "train", cfg.data,
                                            299, seed=seed, device="cuda")
        try:
            n = tiered_match(torch, stream, ref, TIERED_BATCHES,
                             "(b) rawshard vs tiered")
        finally:
            stream.close()
            ref.close()
        # Both loaders observed into one registry: the rawshard one's
        # decode alone.
        prev2 = fresh_registry()
        try:
            stream = rawshard.train_batches(str(data), "train", cfg.data,
                                            299, seed=seed, device="cuda")
            for _ in range(TIERED_BATCHES):
                next(stream)
            stream.close()
            p50 = decode_p50_ms(obs_registry_default())
        finally:
            restore_registry(prev2)
    finally:
        restore_registry(prev)
    auto = grain_pipeline.resolve_decode_workers(0)
    out["rawshard_decode_batch_p50_ms"] = p50
    at_a = out["decode_batch_p50_ms"].get(f"{auto}/0", float("nan"))
    log(f"tiered: (b) {n} rawshard batches (memory-mapped shards) bitwise "
        f"the tiered loader's at the same plan; data.tiered.decode_batch_s "
        f"p50 {p50:.3f} ms for a batch's streamed rows at the automatic "
        f"{auto} thread(s), "
        f"vs {at_a:.3f} ms decoding the records in (a) at {auto} "
        f"thread(s) from step 0 ({smi})")
    torch.cuda.empty_cache()
    return shard_dir


def tiered_fits(torch, seed: int, data: Path, root: Path, smi: str,
                out: dict, loader: str, hbm_step_ms: float) -> list:
    """(c) Eight preset steps (the tuner's pessimal start knobs, set by
    hand) with evals at 4 and 8; the same run cut at step 5 and resumed;
    four fused steps; the cached val eval against the streamed one ->
    the first run's records."""
    from jama16_retina_tpu_torch import trainer
    from jama16_retina_tpu_torch.obs import faultinject

    items = (f"data.loader={loader}",
             tiered_budget(),
             *TIERED_KNOBS)
    cfg_a = fit_config(HBM_STEPS, root / f"{loader}_a", seed, *items)
    res_a, counts_a, recs_a = fit_run(torch, cfg_a, data)
    p50 = decode_p50_ms(obs_registry_default())
    out["launches"][f"{loader}_fit"] = counts_a
    check(counts_a == {"fused_color_jitter": HBM_STEPS,
                       "fused_normalize_color_jitter": 0,
                       "fused_adamw_update": 0,
                       "fused_serve_preprocess": 0},
          f"tiered: (c) the {loader} preset fit launched {counts_a}, want "
          f"B1 = {HBM_STEPS}")
    evals = [r for r in recs_a if r["kind"] == "eval"]
    check([r["step"] for r in evals] == [4, 8]
          and all(0 <= r["val_auc"] <= 1 for r in evals),
          f"tiered: (c) the {loader} fit's evals {evals}")
    train_a = {r["step"]: r for r in recs_a if r["kind"] == "train"}
    step_ms = statistics.median(
        1e3 * r["window_sec"] for s, r in train_a.items()
        if s > 1 and r["pause_sec"] == 0 and r["save_sec"] == 0)
    input_ms = statistics.median(
        1e3 * r["input_wait_sec"] for s, r in train_a.items() if s > 1)
    out["fits"][loader] = {"step_ms": step_ms, "input_wait_ms": input_ms,
                           "decode_batch_p50_ms": p50,
                           "first_input_s": train_a[1]["input_wait_sec"]}
    log(f"tiered: (c) {HBM_STEPS}-step {loader} preset fit ({TIERED_ROWS} "
        f"rows resident, 16 streamed a batch; {', '.join(TIERED_KNOBS)}): "
        f"{res_a}; launches {counts_a}; step median {step_ms:.3f} ms (input "
        f"wait {input_ms:.3f} ms, decode_batch_s p50 {p50:.3f} ms; phase "
        f"18's hbm step {hbm_step_ms:.3f} ms); step 1's input wait, the "
        f"resident load, {train_a[1]['input_wait_sec']:.2f} s ({smi})")

    cut = {"trainer.step": {"kind": "error", "error": "RuntimeError",
                            "on_calls": [HBM_CUT_CALL],
                            "message": f"{loader} cut"}}
    wd_b = root / f"{loader}_b"
    cfg_b = fit_config(HBM_STEPS, wd_b, seed, *items, fault_spec(cut))
    torch.cuda.synchronize()
    reset_launch_counts()
    try:
        trainer.fit(cfg_b, str(data), str(wd_b), device="cuda")
        raised = None
    except RuntimeError as e:
        raised = str(e)
    counts_b1 = launch_counts()
    faultinject.disarm()
    check(raised is not None and f"{loader} cut" in raised
          and counts_b1["fused_color_jitter"] == HBM_CUT_CALL - 1,
          f"tiered: (c) the cut {loader} run raised {raised!r}, launched "
          f"{counts_b1}")
    _, counts_b, recs_b = fit_run(torch, fit_config(
        HBM_STEPS, wd_b, seed, *items, "train.resume=true"), data)
    out["launches"][f"{loader}_fit_cut"] = counts_b1
    out["launches"][f"{loader}_fit_resume"] = counts_b
    check([r["step"] for r in recs_b if r["kind"] == "resume"] == [4]
          and counts_b["fused_color_jitter"] == HBM_STEPS - 4,
          f"tiered: (c) the {loader} resume launched {counts_b}")
    da = state_digest(root / f"{loader}_a", HBM_STEPS)
    db = state_digest(wd_b, HBM_STEPS)
    check(da == db, f"tiered: (c) the resumed {loader} run's step-{HBM_STEPS}"
          f" state {db[:16]} differs from the uninterrupted run's {da[:16]}")
    log(f"tiered: (c) the {loader} run cut by trainer.step at call "
        f"{HBM_CUT_CALL} (launches {counts_b1}) and resumed from 4 (launches "
        f"{counts_b}): the step-{HBM_STEPS} state digest {da[:16]} equals the "
        "uninterrupted run's (cuDNN deterministic)")

    cfg_f = fit_config(HBM_FUSED_STEPS, root / f"{loader}_f", seed, *items,
                       "train.use_pallas_fused=true")
    res_f, counts_f, _ = fit_run(torch, cfg_f, data)
    out["launches"][f"{loader}_fit_fused"] = counts_f
    check(counts_f == {"fused_color_jitter": 0,
                       "fused_normalize_color_jitter": HBM_FUSED_STEPS,
                       "fused_adamw_update": HBM_FUSED_STEPS,
                       "fused_serve_preprocess": 0},
          f"tiered: (c) the {loader} fused fit launched {counts_f}, want B2 "
          f"= B3 = {HBM_FUSED_STEPS}")
    log(f"tiered: (c) {HBM_FUSED_STEPS}-step {loader} fused fit: {res_f}; "
        f"launches {counts_f}")
    ev = cached_val_eval(torch, cfg_a, root / f"{loader}_a", data, HBM_STEPS,
                         f"tiered: (c) {loader}")
    out["fits"][loader].update(ev)
    log(f"tiered: (c) {loader} val eval of {HBM_VAL} images from the "
        f"step-{HBM_STEPS} state: streamed {ev['eval_streamed_ms']:.1f} ms, "
        f"filling the cache {ev['eval_fill_ms']:.1f} ms, from the cache "
        f"{ev['eval_cached_ms']:.1f} ms; cached probabilities bitwise the "
        f"streamed ones ({smi})")
    for wd in ("a", "b", "f"):
        shutil.rmtree(root / f"{loader}_{wd}", ignore_errors=True)
    return recs_a


def tiered_autotune(torch, seed: int, data: Path, root: Path, smi: str,
                    out: dict, hand_set: list) -> None:
    """(d) (c)'s tiered preset fit again with ``data.autotune=true`` from
    the same pessimal knobs: the same losses and AUCs."""
    items = ("data.loader=tiered",
             tiered_budget(),
             *TIERED_KNOBS, "data.autotune=true")
    cfg = fit_config(HBM_STEPS, root / "tiered_tuned", seed, *items)
    res, counts, recs = fit_run(torch, cfg, data)
    snap = obs_registry_default().snapshot()
    out["launches"]["tiered_fit_autotune"] = counts
    check(counts["fused_color_jitter"] == HBM_STEPS,
          f"tiered: (d) the autotuned fit launched {counts}")

    def curves(rs):
        return ({r["step"]: r["loss"] for r in rs if r["kind"] == "train"},
                {r["step"]: r["val_auc"] for r in rs if r["kind"] == "eval"})

    check(curves(recs) == curves(hand_set) and curves(recs)[1],
          f"tiered: (d) the autotuned fit's curves {curves(recs)} differ "
          f"from the hand-set fit's {curves(hand_set)}")
    adj = {k: v for k, v in snap["counters"].items()
           if k.startswith("data.autotune.")}
    knobs = {k: v for k, v in snap["gauges"].items()
             if k.startswith("data.autotune.")}
    out["autotune"] = {"adjustments": adj, "knobs": knobs}
    log(f"tiered: (d) autotuned tiered fit from {', '.join(TIERED_KNOBS)}: "
        f"{res}; launches {counts}; losses and val AUCs bitwise the hand-set "
        f"fit's; adjustments {adj}; knobs at the end {knobs}")
    shutil.rmtree(root / "tiered_tuned", ignore_errors=True)


def tiered_poison(torch, seed: int, data: Path, root: Path, shard_dir: Path,
                  out: dict) -> None:
    """(e) A ``tfrecord.read`` corrupt plan aimed at a streamed record, in
    the loader and in the host reference; then a damaged shard in a copy
    of (b)'s shards."""
    import numpy as np

    from jama16_retina_tpu_torch.data import rawshard, tiered_pipeline
    from jama16_retina_tpu_torch.obs import faultinject

    cfg = tiered_config(seed, "data.decode_workers=1")
    plan = tiered_pipeline._TierPlan(HBM_RECORDS, TRAIN_BATCH, TIERED_ROWS,
                                     seed)
    # One decode thread: the resident tier reads records 0-2047 as calls
    # 1-2048, then batch 0's streamed rows; the reference reads batch 0's
    # resident rows, then its streamed ones.
    calls = {"loader": TIERED_ROWS + 3, "reference": plan.res_pb + 3}
    batches, counts = {}, {}
    for who, call in calls.items():
        prev = fresh_registry()
        faultinject.arm({"tfrecord.read": {"kind": "corrupt",
                                           "on_calls": [call]}})
        try:
            if who == "loader":
                it = tiered_pipeline.train_batches(str(data), "train",
                                                   cfg.data, 299, seed=seed,
                                                   device="cuda")
            else:
                it = tiered_pipeline.host_reference_batches(
                    str(data), "train", cfg.data, 299, seed=seed,
                    capacity_rows=TIERED_ROWS)
            try:
                batches[who] = [
                    {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                         else v) for k, v in next(it).items()}
                    for _ in range(TIERED_POISON_BATCHES)]
            finally:
                it.close()
            counts[who] = {k: v for k, v in obs_registry_default().snapshot()[
                "counters"].items() if k.startswith("data.quarantined")}
        finally:
            faultinject.disarm()
            restore_registry(prev)
    clean = tiered_pipeline.host_reference_batches(
        str(data), "train", cfg.data, 299, seed=seed,
        capacity_rows=TIERED_ROWS)
    first = next(clean)
    clean.close()
    bad = plan.res_pb + 2
    differs = [j for j in range(TRAIN_BATCH) if not np.array_equal(
        batches["loader"][0]["image"][j], first["image"][j])]
    check(all(np.array_equal(a[k], b[k]) for a, b in zip(
        batches["loader"], batches["reference"]) for k in a)
          and differs == [bad],
          f"tiered: (e) the poisoned loader differs from the poisoned host "
          f"reference, or batch 0 differs from the clean one in rows "
          f"{differs} (want [{bad}])")
    want = {"data.quarantined": 1, "data.quarantined.decode_error": 1}
    check(counts["loader"] == counts["reference"] == want,
          f"tiered: (e) quarantine counters {counts}")
    rec = plan.batch_indices(0)[1][2]
    log(f"tiered: (e) tfrecord.read corrupt on the loader's call "
        f"{calls['loader']} and the reference's call {calls['reference']} "
        f"(both streamed record {rec}, row {bad} of batch 0): {want}; "
        f"{TIERED_POISON_BATCHES} batches bitwise the poisoned host "
        f"reference, record {rec} replaced by record {rec + 1}")
    out["poison"] = counts["loader"]

    # A damaged shard: the images file of shard 8 (records 2048-2303, the
    # streamed tier) with a header claiming another shape at the same
    # size; the other files linked from (b)'s shards.
    damaged = root / "shards_damaged"
    shutil.rmtree(damaged, ignore_errors=True)
    damaged.mkdir()
    split = rawshard.RawShardSplit(str(shard_dir), "train", image_size=299)
    entry = split._entries[TIERED_DAMAGED_SHARD]
    for f in shard_dir.iterdir():
        if f.name == entry["images"]:
            raw = f.read_bytes()
            torn = raw.replace(b"(256, 299, 299, 3), }",
                               b"(128, 598, 299, 3), }")
            check(torn != raw and len(torn) == len(raw),
                  "tiered: (e) the shard header was not rewritten")
            (damaged / f.name).write_bytes(torn)
        elif f.suffix == ".json":
            shutil.copy(f, damaged / f.name)
        else:
            (damaged / f.name).symlink_to(f)
    lo, hi = entry["start"], entry["start"] + entry["records"]
    prev = fresh_registry()
    try:
        c = tiered_config(seed, "data.decode_workers=1",
                          f"data.rawshard_dir={damaged}")
        it = rawshard.train_batches(str(data), "train", c.data, 299,
                                    seed=seed, device="cuda")
        try:
            hit = 0
            for step in range(TIERED_POISON_BATCHES):
                got = next(it)
                ids = np.concatenate(plan.batch_indices(step))
                subs = [hi % HBM_RECORDS if lo <= i < hi else int(i)
                        for i in ids]
                hit += sum(lo <= i < hi for i in ids)
                want_i = np.stack([split.row(i)["image"] for i in subs])
                check(torch.equal(got["image"].cpu(),
                                  torch.from_numpy(want_i)),
                      f"tiered: (e) damaged-shard batch {step} differs")
        finally:
            it.close()
        counters = obs_registry_default().snapshot()["counters"]
    finally:
        restore_registry(prev)
    depth = tiered_pipeline.resolve_stage_depth(c.data)
    read = sum(lo <= i < hi for step in range(TIERED_POISON_BATCHES + depth)
               for i in plan.batch_indices(step)[1])
    check(hit > 0 and counters.get("data.quarantined.decode_error") == read,
          f"tiered: (e) {hit} damaged rows in the batches, {read} read, "
          f"counters {counters}")
    log(f"tiered: (e) shard {TIERED_DAMAGED_SHARD} (records {lo}-{hi - 1}) "
        f"damaged in a copy of (b)'s shards: {read} streamed reads "
        f"quarantined (data.quarantined.decode_error "
        f"{counters['data.quarantined.decode_error']}, data.quarantined "
        f"{counters['data.quarantined']} with the forward scan), each "
        f"replaced by record {hi}; {TIERED_POISON_BATCHES} batches bitwise "
        f"the shard rows with that substitute ({hit} rows)")
    out["damaged_shard"] = {"reads": read, "rows": hit,
                            "decode_error": counters[
                                "data.quarantined.decode_error"]}
    shutil.rmtree(damaged, ignore_errors=True)


def phase_tiered(torch, seed: int, smi: str, hbm: dict) -> dict:
    """The tiered and rawshard loaders alone first, then fits from them
    (phase 19 of the docstring), on phase 18's splits, which it removes."""
    t_phase = time.perf_counter()
    root, data = hbm["root"], hbm["data"]
    out = {"launches": {}, "wall_s": {}, "decode_batch_p50_ms": {},
           "fits": {}}
    try:
        with HbmPart("a", "the tiered loader alone", out, "tiered"):
            tiered_alone(torch, seed, data, smi, out)
        with HbmPart("b", "the rawshard transcode and loader alone", out,
                     "tiered"):
            shard_dir = rawshard_alone(torch, seed, data, smi, out)
        with HbmPart("c", "fits from each loader", out, "tiered"):
            hand_set = tiered_fits(torch, seed, data, root, smi, out,
                                   "tiered", hbm["step_ms"])
            tiered_fits(torch, seed, data, root, smi, out, "rawshard",
                        hbm["step_ms"])
        with HbmPart("d", "the autotuned fit", out, "tiered"):
            tiered_autotune(torch, seed, data, root, smi, out, hand_set)
        with HbmPart("e", "poison drills", out, "tiered"):
            tiered_poison(torch, seed, data, root, shard_dir, out)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# Phase 20: the grain loader, and progressive JPEG.
GRAIN_ORDER = ROOT / "tests" / "data" / "grain_order.json"
GRAIN_FUSED_STEPS = 4
GRAIN_CUT_CALL = 5
# A still-refused JPEG: a baseline fixture with its frame marked
# arithmetic-coded (SOF9).
ARITHMETIC_SOURCE = "fundus299_0.jpg"


def arithmetic_jpeg() -> bytes:
    data = (FIXTURES / ARITHMETIC_SOURCE).read_bytes()
    return data.replace(b"\xff\xc0", b"\xff\xc9", 1)


def grain_reference_keys(sampler, workers: int, start: int,
                         count: int) -> list:
    """Record keys of batches ``start`` .. ``start + count - 1`` of a grain
    stream from its beginning, worked out apart from the iterator: in
    process batch b holds positions b*B ..; with W workers it is worker b
    % W's batch b // W, whose slice positions j are local positions w +
    j*W."""
    import numpy as np

    keys = []
    for b in range(start, start + count):
        if workers:
            w, k = b % workers, b // workers
            j = np.arange(k * GRAIN_BATCH, (k + 1) * GRAIN_BATCH)
            pos = w + j * workers
        else:
            pos = np.arange(b * GRAIN_BATCH, (b + 1) * GRAIN_BATCH)
        keys.append(sampler.record_keys(pos))
    return keys


def grain_match(it, rows, grades, keys, what: str,
                states: "dict | None" = None, at0: int = 0) -> dict:
    """``it``'s next batches bitwise the host rows gathered by ``keys``;
    the state bytes after each batch whose ordinal (from ``at0``) is in
    ``states`` -> {ordinal: state bytes}."""
    import numpy as np

    seen = {}
    for b, k in enumerate(keys, start=at0 + 1):
        batch = next(it)
        ok = (np.array_equal(batch["image"], rows[k])
              and np.array_equal(batch["grade"], grades[k]))
        check(ok, f"grain: (b) {what}: batch {b} differs from the host "
              "reference")
        if states is not None and b in states:
            seen[b] = it.get_state()
    return seen


def grain_alone(data: Path, smi: str, out: dict) -> None:
    """(a) the order alone, (b) the batches alone."""
    import hashlib

    import numpy as np

    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.data import grain_index, grain_pipeline

    with open(GRAIN_ORDER) as f:
        want = json.load(f)

    def digest(a) -> str:
        return hashlib.sha256(bytes(a)).hexdigest()

    with HbmPart("a", "the order alone", out, "grain"):
        for seed, d in sorted(want["order_2_epochs"].items()):
            keys = grain_index.IndexSampler(
                GRAIN_RECORDS, grain_index.ShardOptions(0, 1, True),
                int(seed)).record_keys(np.arange(2 * GRAIN_RECORDS))
            check(digest(keys.astype(np.int64)) == d,
                  f"grain: (a) the sampler's 2 epochs at seed {seed} differ "
                  "from grain's")
        log(f"grain: (a) IndexSampler's first 2 epochs of {GRAIN_RECORDS} "
            "records at seeds 0 and 42 (grain's index_shuffle of each "
            "epoch): bitwise the digests recorded from grain")

    with HbmPart("b", "batches alone", out, "grain"):
        cfg = configs.override(configs.get_config("eyepacs_binary"), [
            f"data.batch_size={GRAIN_BATCH}"])
        source = grain_pipeline.FundusSource(str(data), "train", GRAIN_SIZE)
        check(len(source) == GRAIN_RECORDS == want["records"],
              f"grain: (b) the split holds {len(source)} records")
        t0 = time.perf_counter()
        decoded = [source[i] for i in range(len(source))]
        rows = np.stack([r["image"] for r in decoded])
        grades = np.array([r["grade"] for r in decoded], np.int32)
        host_s = time.perf_counter() - t0
        sampler = grain_index.IndexSampler(
            GRAIN_RECORDS, grain_index.ShardOptions(0, 1, True), GRAIN_SEED)
        rates = {}
        for workers in GRAIN_WORKERS:
            keys = grain_reference_keys(sampler, workers, 0, GRAIN_BATCHES)
            it = grain_pipeline.train_batches(
                str(data), "train", cfg.data, GRAIN_SIZE, seed=GRAIN_SEED,
                worker_count=workers)
            t0 = time.perf_counter()
            try:
                states = grain_match(
                    it, rows, grades, keys, f"{workers} workers",
                    states=set(GRAIN_STATE_AT) | {GRAIN_STATE_AT[0]
                                                  + GRAIN_RESUMED})
            finally:
                it.close()
            rates[workers] = GRAIN_BATCHES * GRAIN_BATCH / (
                time.perf_counter() - t0)
            for b in GRAIN_STATE_AT:
                check(digest(states[b]) == want["states"][str(workers)][
                    str(b)], f"grain: (b) {workers} workers: the state after "
                    f"batch {b} differs from the reference's")
            at = GRAIN_STATE_AT[0]
            tail = grain_reference_keys(sampler, workers, at, GRAIN_RESUMED)
            starts = [("set_state", states[at])]
            if workers == 0:
                starts.append(("skip_batches", None))
            for how, state in starts:
                it = grain_pipeline.train_batches(
                    str(data), "train", cfg.data, GRAIN_SIZE,
                    seed=GRAIN_SEED, worker_count=workers,
                    skip_batches=at if state is None else 0,
                    initial_state=state)
                try:
                    after = grain_match(
                        it, rows, grades, tail,
                        f"{workers} workers from {how} at {at}",
                        states={at + GRAIN_RESUMED}, at0=at)
                finally:
                    it.close()
                check(after[at + GRAIN_RESUMED]
                      == states[at + GRAIN_RESUMED],
                      f"grain: (b) {workers} workers from {how}: the state "
                      "differs from the uninterrupted stream's")
        out["records_per_s"] = {str(k): v for k, v in rates.items()}
        log(f"grain: (b) {GRAIN_BATCHES} batches of {GRAIN_BATCH} "
            f"({GRAIN_BATCHES * GRAIN_BATCH // GRAIN_RECORDS} epochs) at "
            f"workers {list(GRAIN_WORKERS)}, each bitwise the host reference "
            f"(the port's order, {GRAIN_RECORDS} records decoded once by "
            f"_decode_example in {host_s:.2f} s); state bytes after batches "
            f"{list(GRAIN_STATE_AT)} bitwise the reference's digests; "
            f"{GRAIN_RESUMED} batches from skip_batches (in process) and "
            f"from set_state at {GRAIN_STATE_AT[0]}, past the epoch "
            f"boundary, bitwise and with the uninterrupted states; records "
            f"a second by workers { {k: round(v, 1) for k, v in rates.items()} }"
            f" ({smi})")


def grain_fits(torch, seed: int, data: Path, root: Path, smi: str,
               out: dict) -> None:
    """(c) Per worker count: 8 preset steps, the same run cut at step 5
    and resumed; then 4 fused steps."""
    from jama16_retina_tpu_torch import trainer
    from jama16_retina_tpu_torch.obs import faultinject

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    zero = {"fused_color_jitter": 0, "fused_normalize_color_jitter": 0,
            "fused_adamw_update": 0, "fused_serve_preprocess": 0}
    try:
        for workers in GRAIN_WORKERS:
            grain = ("data.loader=grain", f"data.grain_workers={workers}")
            tag = f"w{workers}"
            wd_a = root / f"a{workers}"
            res_a, counts_a, recs_a = fit_run(
                torch, fit_config(FIT_STEPS, wd_a, seed, *grain), data)
            out["launches"][f"grain_fit_{tag}"] = counts_a
            check(counts_a == {**zero, "fused_color_jitter": FIT_STEPS},
                  f"grain: (c) the {workers}-worker preset fit launched "
                  f"{counts_a}, want B1 = {FIT_STEPS}")
            evals = [r for r in recs_a if r["kind"] == "eval"]
            check([r["step"] for r in evals] == [4, 8]
                  and all(0 <= r["val_auc"] <= 1 for r in evals),
                  f"grain: (c) the fit's evals {evals}")
            train_a = {r["step"]: r for r in recs_a if r["kind"] == "train"}
            step_ms = statistics.median(
                1e3 * r["window_sec"] for s, r in train_a.items()
                if s > 1 and r["pause_sec"] == 0 and r["save_sec"] == 0)
            input_ms = statistics.median(
                1e3 * r["input_wait_sec"] for s, r in train_a.items()
                if s > 1)
            out["fits"][tag] = {"step_ms": step_ms, "input_wait_ms": input_ms,
                                "first_input_s": train_a[1][
                                    "input_wait_sec"]}
            log(f"grain: (c) {FIT_STEPS}-step preset fit at {workers} "
                f"workers: {res_a}; launches {counts_a}; step median "
                f"{step_ms:.3f} ms, input wait median "
                f"{input_ms:.3f} ms (step 1: "
                f"{train_a[1]['input_wait_sec']:.2f} s) ({smi})")

            cut = {"trainer.step": {"kind": "error", "error": "RuntimeError",
                                    "on_calls": [GRAIN_CUT_CALL],
                                    "message": "grain cut"}}
            wd_b = root / f"b{workers}"
            torch.cuda.synchronize()
            reset_launch_counts()
            try:
                trainer.fit(fit_config(FIT_STEPS, wd_b, seed, *grain,
                                       fault_spec(cut)),
                            str(data), str(wd_b), device="cuda")
                raised = None
            except RuntimeError as e:
                raised = str(e)
            counts_b1 = launch_counts()
            faultinject.disarm()
            check(raised is not None and "grain cut" in raised
                  and counts_b1["fused_color_jitter"] == GRAIN_CUT_CALL - 1,
                  f"grain: (c) the cut run raised {raised!r}, launched "
                  f"{counts_b1}")
            state_file = wd_b / "grain_state" / "4.json"
            check(state_file.exists() == (workers > 0),
                  f"grain: (c) {workers} workers: grain_state/4.json "
                  f"exists: {state_file.exists()}")
            if workers:
                check(state_file.read_bytes()
                      == (wd_a / "grain_state" / "4.json").read_bytes(),
                      "grain: (c) the cut run's step-4 state differs from "
                      "the uninterrupted run's")
            _, counts_b, recs_b = fit_run(torch, fit_config(
                FIT_STEPS, wd_b, seed, *grain, "train.resume=true"), data)
            out["launches"][f"grain_fit_{tag}_cut"] = counts_b1
            out["launches"][f"grain_fit_{tag}_resume"] = counts_b
            check([r["step"] for r in recs_b if r["kind"] == "resume"] == [4]
                  and counts_b["fused_color_jitter"] == FIT_STEPS - 4,
                  f"grain: (c) the resume launched {counts_b}")
            da, db = (state_digest(wd_a, FIT_STEPS),
                      state_digest(wd_b, FIT_STEPS))
            check(da == db, f"grain: (c) {workers} workers: the resumed "
                  f"run's step-{FIT_STEPS} state {db[:16]} differs from the "
                  f"uninterrupted run's {da[:16]}")
            how = ("grain_state/4.json" if workers
                   else "state_at_step (no state file)")
            log(f"grain: (c) {workers} workers: the run cut by trainer.step "
                f"at call {GRAIN_CUT_CALL} (launches {counts_b1}) and "
                f"resumed from 4 through {how} (launches {counts_b}): the "
                f"step-{FIT_STEPS} state digest {da[:16]} equals the "
                "uninterrupted run's (cuDNN deterministic)")
            shutil.rmtree(wd_b, ignore_errors=True)

        res_f, counts_f, _ = fit_run(torch, fit_config(
            GRAIN_FUSED_STEPS, root / "f", seed, "data.loader=grain",
            "train.use_pallas_fused=true"), data)
        out["launches"]["grain_fit_fused"] = counts_f
        check(counts_f == {**zero,
                           "fused_normalize_color_jitter": GRAIN_FUSED_STEPS,
                           "fused_adamw_update": GRAIN_FUSED_STEPS},
              f"grain: (c) the fused fit launched {counts_f}, want B2 = B3 "
              f"= {GRAIN_FUSED_STEPS}")
        log(f"grain: (c) {GRAIN_FUSED_STEPS}-step fused fit: {res_f}; "
            f"launches {counts_f}")
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


def progressive_decodes(out: dict) -> None:
    """(d) Every progressive fixture on the host path, the records path
    (a record's encoded image through ``tfrecord.parse_record``) and the
    grain loader's ``_decode_example``, bitwise its manifest digests; a
    truncated one refused."""
    from jama16_retina_tpu_torch.data import (grain_pipeline, imdecode, jpeg,
                                              tfrecord)

    manifest = fixture_manifest()
    names = sorted(n for n in manifest if n.startswith("progressive"))
    for name in names:
        data = (FIXTURES / name).read_bytes()
        entry = manifest[name]
        host = imdecode.imdecode(data)
        check(host is not None and sha256(host) == entry["cv2_rgb"],
              f"grain: (d) {name}: the host decode differs from OpenCV's")
        payload = tfrecord.make_jpeg_example(data, 1, name)
        rec = tfrecord.parse_record(payload)
        check(sha256(rec.image) == entry["tf_rgb"],
              f"grain: (d) {name}: the records decode differs from "
              "TensorFlow's")
        h, w = entry["cv2_shape"][:2]
        if h == w:
            row = grain_pipeline._decode_example(payload, h)
            check(sha256(row["image"]) == entry["cv2_rgb"],
                  f"grain: (d) {name}: _decode_example differs from "
                  "OpenCV's")
        try:
            jpeg.decode_jpeg(data[:len(data) // 2], exif_orientation=False)
            refused = None
        except jpeg.JpegError as e:
            refused = e.code
        check(refused == -2, f"grain: (d) {name} cut in half: {refused}")
    out["progressive_fixtures"] = len(names)
    log(f"grain: (d) {len(names)} progressive fixtures ({names}) bitwise "
        "their manifest digests on the host path, the records path and "
        "(the square one) _decode_example; each cut in half refused as "
        "truncated")


def predict_progressive(torch, serve: dict, root: Path, smi: str,
                        out: dict) -> None:
    """(d) ``predict --images`` with ``serve.fused_preprocess=true`` on the
    progressive photo and a baseline one: B4 once per chunk, canvases
    bitwise the manifest's, rows against the CPU engine."""
    import numpy as np

    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.serve import host
    from jama16_retina_tpu_torch.serve.engine import ServingEngine

    images = root / "images"
    images.mkdir(parents=True)
    photos = ["progressive.jpg", "fundus299_1.jpg"]
    for name in photos:
        shutil.copy(FIXTURES / name, images / name)
    sets = ["serve.fused_preprocess=true", "model.compute_dtype=float32"]
    argv = [f"--checkpoint_dir={Path(serve['dirs'][0]).parent}",
            f"--images={images}", "--config=eyepacs_binary",
            f"--batch_size={PREDICT_BATCH}", "--threshold=0.5",
            *[a for s in sets for a in ("--set", s)]]
    torch.cuda.synchronize()
    reset_launch_counts()
    code, rows = predict_rows(argv)
    counts = launch_counts()
    out["launches"]["grain_predict_progressive"] = counts
    chunks = -(-len(photos) // PREDICT_BATCH)
    check(code == 0 and [Path(r["image"]).name for r in rows]
          == sorted(photos) and all("error" not in r for r in rows),
          f"grain: (d) predict rows {rows}")
    check(counts["fused_serve_preprocess"] == chunks
          and sum(counts.values()) == chunks,
          f"grain: (d) predict launched {counts}, want B4 once per chunk "
          f"({chunks})")
    manifest = fixture_manifest()
    paths = [str(images / n) for n in sorted(photos)]
    pre = host.preprocess_paths(paths, 299, registry=Registry())
    bad = [Path(p).name for p, c in zip(pre.kept, pre.images)
           if sha256(c) != manifest[Path(p).name]["canvas299"]]
    check(len(pre.kept) == len(photos) and not bad,
          f"grain: (d) canvases differ from the manifest: {bad}")
    cfg = configs.override(configs.get_config("eyepacs_binary"), sets + [
        f"serve.max_batch={PREDICT_BATCH}",
        f"serve.bucket_sizes={PREDICT_BATCH}"])
    want = ServingEngine(cfg, serve["dirs"], device="cpu",
                         registry=Registry()).probs(pre.images)
    dev = float(np.max(np.abs(np.array([r["prob"] for r in rows]) - want)))
    out["predict_cpu_dev"] = dev
    check(dev <= 1e-4, f"grain: (d) predict rows differ from the CPU engine "
          f"by {dev}")
    log(f"grain: (d) predict --images on {photos}: launches {counts}; both "
        f"canvases bitwise the manifest's; card rows vs the CPU engine max "
        f"|prob diff| {dev:.3e} (atol 1e-4, TF32 off) ({smi})")


def phase_grain(torch, seed: int, smi: str, serve: dict, data: Path) -> dict:
    """The grain loader alone first, then fits from it, then progressive
    JPEG (phase 20 of the docstring), on phase 6's splits ``data``."""
    t_phase = time.perf_counter()
    root = SCRATCH / "grain"
    shutil.rmtree(root, ignore_errors=True)
    out = {"launches": {}, "wall_s": {}, "fits": {}}
    try:
        grain_alone(data, smi, out)
        with HbmPart("c", "fits from the grain loader", out, "grain"):
            grain_fits(torch, seed, data, root, smi, out)
        with HbmPart("d", "progressive JPEG", out, "grain"):
            progressive_decodes(out)
            predict_progressive(torch, serve, root, smi, out)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# Phase 21: the lifecycle controller on phase 6's splits, k = 2 calibrated
# random Inception-v3 members at full width.
LC_K = 2
LC_RETRAIN_STEPS = 4
LC_CANARY = 8
LC_REQUEST_ROWS = 8
LC_SHADOW_REQUESTS = 2
LC_VAL_ROWS = 32
# The gauge part (c)'s watch rule reads; the phase sets it after the swap.
LC_GAUGE = "chip_smoke.regression"
# Random members score every val image within a few hundredths, in one or
# two of the profile's 20 bins, and rank the 32 rows near chance: a retrain
# that moves the scores a little moves that histogram across a bin edge
# (debiased PSI far above obs.quality.psi_alert) and can reorder a few
# pairs. So the parity and AUC bounds are opened; the gates still score
# and print their values, and the canary bound keeps its default (0.2).
LC_PSI_MAX = 100.0
LC_AUC_DELTA = 0.25
# A warm start fine-tunes at a small learning rate: at the preset's 1e-3
# (cosine, no warmup) 4 AdamW steps move a random Inception-v3's canary
# scores by 0.54 on an H100, past the canary bound.
LC_LEARNING_RATE = 1e-5
LC_SETS = (
    "serve.fused_preprocess=true", "serve.max_batch=32",
    f"data.batch_size={TRAIN_BATCH}",
    f"train.learning_rate={LC_LEARNING_RATE}", "obs.quality.enabled=true",
    "obs.quality.canary_every_s=0", "lifecycle.enabled=true",
    f"lifecycle.retrain_steps={LC_RETRAIN_STEPS}",
    f"lifecycle.gate_eval_rows={LC_VAL_ROWS}",
    f"lifecycle.gate_parity_psi_max={LC_PSI_MAX}",
    f"lifecycle.gate_auc_floor_delta={LC_AUC_DELTA}",
    "lifecycle.shadow_fraction=1",
    f"lifecycle.shadow_requests={LC_SHADOW_REQUESTS}",
    "lifecycle.watch_probes=1", "lifecycle.watch_interval_s=0")
LC_STATES = ["DRIFT_DETECTED", "RETRAIN", "GATE", "STAGED_ROLLOUT", "WATCH"]


class LcClient:
    """A thread that sends ``rows`` through the micro-batcher, one request
    after another, from ``__enter__`` to ``__exit__``: its requests, and
    the errors of any that failed."""

    def __init__(self, batcher, rows):
        import threading

        self.batcher, self.rows = batcher, rows
        self.ok, self.failures = 0, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                out = self.batcher.submit(self.rows).result(timeout=120)
                check(len(out) == len(self.rows), f"client got {len(out)} "
                      f"rows for {len(self.rows)}")
                self.ok += 1
            except Exception as e:  # noqa: BLE001 - counted, then checked
                self.failures.append(f"{type(e).__name__}: {e}")

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *_):
        self._stop.set()
        self._thread.join(timeout=180)
        check(not self._thread.is_alive(), "lifecycle: the client thread "
              "did not stop")
        return False


def lc_members(torch, cfg, root: Path, seed: int, train) -> list:
    """``LC_K`` random members made as ``save_random_members`` makes them,
    each with its BatchNorm statistics set to those of the ``train``
    split's images (uint8) augmented as the retrain augments them (the
    plain augment, one train-mode forward at momentum 0, as
    ``calibrate`` does): the retrain's batches then move the running
    statistics by their sampling noise, not across the board, and the
    candidate scores near the live model."""
    import dataclasses

    from jama16_retina_tpu_torch import models
    from jama16_retina_tpu_torch.data import augment
    from jama16_retina_tpu_torch.models import convert
    from jama16_retina_tpu_torch.models.common import BatchNorm
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

    plain = dataclasses.replace(cfg.data, use_pallas=False)
    dirs = []
    for m in range(LC_K):
        model = random_member(models.build(cfg.model),
                              torch.Generator().manual_seed(seed + m))
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                mod.momentum = 0.0
            if hasattr(mod, "drop_rate"):
                mod.drop_rate = 0.0
        model.cuda()
        with torch.no_grad():
            x = augment.augment_batch(
                torch.Generator(device="cuda").manual_seed(seed + 50 + m),
                torch.from_numpy(train).cuda(), plain)
            model(x.permute(0, 3, 1, 2), train=True)
        model.cpu()
        d = ckpt_lib.member_dir(str(root), m)
        ckpt_lib.save_member(d, convert.torch_to_flax(model))
        dirs.append(d)
    return dirs


def lc_setup(torch, seed: int, data: Path, root: Path, smi: str) -> dict:
    """The live members, the golden canary pinned and a reference profile
    built on the val split through a probe engine (as a deployment pins
    them offline), then the serving engine with both on a registry of its
    own (a retrain's fit resets the process registry)."""
    import numpy as np

    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.data import tfrecord
    from jama16_retina_tpu_torch.data.grain_pipeline import (
        ParallelDecoder, TFRecordIndex)
    from jama16_retina_tpu_torch.eval import metrics
    from jama16_retina_tpu_torch.obs import quality
    from jama16_retina_tpu_torch.obs.registry import Registry
    from jama16_retina_tpu_torch.serve.engine import ServingEngine

    base = configs.override(configs.get_config("eyepacs_binary"),
                            list(LC_SETS))
    split = {}
    for name, n in (("train", FIT_SPLITS[0][1]), ("val", LC_VAL_ROWS)):
        dec = ParallelDecoder(TFRecordIndex(tfrecord.list_split(str(data),
                                                                name)),
                              299, workers=4, registry=Registry())
        try:
            split[name] = dec.decode_batch(range(n))["image"]
        finally:
            dec.close()
    val = split["val"]
    live = lc_members(torch, base, root / "live", seed + 700, split["train"])
    canary = render(seed + 900, LC_CANARY)
    probe = ServingEngine(
        configs.override(base, ["obs.quality.enabled=false"]), live,
        device="cuda", registry=Registry())
    pinned = np.asarray(metrics.ensemble_average(list(
        probe.member_probs(canary))), np.float64).ravel()
    val_scores = metrics.ensemble_average(list(probe.member_probs(val)))
    del probe
    canary_path = quality.save_canary(str(root / "canary"), canary,
                                      scores=pinned)
    profile = quality.build_profile(np.asarray(val_scores, np.float64),
                                    bins=base.obs.quality.score_bins)
    profile_path = quality.save_profile(str(root / "profile.json"), profile)
    sets = [*LC_SETS, f"obs.quality.canary_path={canary_path}",
            f"obs.quality.profile_path={profile_path}"]
    cfg = configs.override(configs.get_config("eyepacs_binary"), sets)
    reg = Registry()
    engine = ServingEngine(cfg, live, device="cuda", registry=reg)
    check(engine.quality.canary.reference is not None
          and engine.quality.profile is not None,
          "lifecycle: the engine loaded no pinned canary or no profile")
    fixed = render(seed + 950, LC_REQUEST_ROWS)
    log(f"lifecycle: setup: {LC_K} live members (Inception-v3, "
        f"{cfg.model.compute_dtype}, BN statistics of the augmented train "
        f"split), canary of {LC_CANARY} "
        f"canvases pinned, profile of {LC_VAL_ROWS} val scores; val score "
        f"range [{float(np.min(val_scores)):.4f}, "
        f"{float(np.max(val_scores)):.4f}]")
    return {"cfg": cfg, "sets": sets, "live": live, "engine": engine,
            "reg": reg, "profile": profile, "fixed": fixed,
            "canary_path": canary_path, "profile_path": profile_path,
            "wd": root / "wd", "data": data}


def lc_controller(lc: dict, cfg, retrain_fn=None):
    from jama16_retina_tpu_torch.lifecycle import LifecycleController

    return LifecycleController(
        cfg, str(lc["wd"]), engine=lc["engine"], registry=lc["reg"],
        data_dir=str(lc["data"]), retrain_fn=retrain_fn,
        live_member_dirs=lc["live"])


def lc_fit_chunks(cfg, cand: list) -> int:
    """Chunks the retrain's fits scored in their evals: each fit's eval
    engine takes the deployment's serve section (B4 on), and scores the
    val split in eval batches padded to ``eval.batch_size``, each cut into
    chunks of ``serve.max_batch``."""
    import math

    from jama16_retina_tpu_torch.utils.logging import read_jsonl

    evals = sum(r["kind"] == "eval" for d in cand
                for r in read_jsonl(f"{d}/metrics.jsonl"))
    return evals * math.ceil(FIT_SPLITS[1][1] / cfg.eval.batch_size) * (
        math.ceil(cfg.eval.batch_size / cfg.serve.max_batch))


def lc_part_counts(lc: dict, part: str, out: dict, want: dict,
                   fit_chunks: int = 0) -> dict:
    """The part's launches, read just after it (set to 0 just before):
    B4 once a chunk the engine served or scored and once a chunk of the
    retrain's evals, the train kernels as ``want`` says."""
    counts = launch_counts()
    chunks = lc["engine"].chunks_dispatched + fit_chunks
    out["launches"][f"lifecycle_{part}"] = counts
    out["chunks"][part] = chunks
    check(counts["fused_serve_preprocess"] == chunks and chunks > 0,
          f"lifecycle: ({part}) B4 launched {counts['fused_serve_preprocess']}"
          f" times for {chunks} chunks ({fit_chunks} of them the retrain's "
          "evals)")
    got = {k: counts[k] for k in want}
    check(got == want, f"lifecycle: ({part}) launched {counts}, want {want}")
    return counts


def lc_begin(lc: dict) -> None:
    import torch

    torch.cuda.synchronize()
    reset_launch_counts()
    lc["engine"].chunks_dispatched = 0


def lc_timeline(ctl) -> dict:
    """States, seconds from trigger to the terminal state, and the shadow's
    requests of the controller's newest cycle."""
    entries = ctl.journal.cycle_entries()
    rollout = ctl.journal.find("STAGED_ROLLOUT")
    return {"states": [e["state"] for e in entries],
            "trigger_to_end_s": round(entries[-1]["t"] - entries[0]["t"], 3),
            "shadow_requests": (rollout["shadow"]["requests"]
                                if rollout else None)}


def lc_verdicts(gate: dict) -> str:
    return "; ".join(
        f"{v['name']} {'pass' if v['passed'] else 'FAIL'}"
        f"{' (skipped)' if v['skipped'] else ''} value {v['value']} "
        f"threshold {v['threshold']}{' ' + v['detail'] if v['detail'] else ''}"
        for v in gate["verdicts"])


def lc_good_cycle(torch, lc: dict, smi: str, out: dict) -> None:
    """(a) drift alert -> on_fire -> the default retrain (B1 each preset
    step) -> the three gates -> shadow over live traffic -> promote ->
    watch -> COMMIT."""
    import dataclasses

    import numpy as np

    from jama16_retina_tpu_torch.eval import metrics
    from jama16_retina_tpu_torch.obs import alerts, quality

    cfg, engine, reg, fixed = lc["cfg"], lc["engine"], lc["reg"], lc["fixed"]
    lc_begin(lc)
    ctl = lc_controller(lc, cfg)
    monitor = quality.QualityMonitor(
        dataclasses.replace(cfg.obs.quality, window_scores=256),
        registry=reg, profile=lc["profile"])
    mgr = alerts.AlertManager(alerts.quality_rules(cfg.obs.quality),
                              registry=reg, on_fire=ctl.on_alert)
    mgr.evaluate(now=0.0)
    check(ctl.state == "IDLE", f"lifecycle: (a) opened at {ctl.state} with "
          "no drift")
    monitor.observe(None, np.random.default_rng(0).uniform(0.85, 0.99, 256))
    fired = [f["reason"] for f in mgr.evaluate(now=1.0)]
    check("quality_drift" in fired and ctl.state == "DRIFT_DETECTED",
          f"lifecycle: (a) the drifted window fired {fired}; state "
          f"{ctl.state}")
    t0 = time.perf_counter()
    ctl.step()
    retrain_s = time.perf_counter() - t0
    cand = ctl.journal.find("RETRAIN")["member_dirs"]
    markers = [Path(d) / "RETRAIN_DONE.json" for d in cand]
    check(len(cand) == LC_K and all(m.exists() for m in markers),
          f"lifecycle: (a) RETRAIN left {cand}")
    ctl.step()
    gate = ctl.journal.find("GATE")
    check(gate["passed"] and [v["name"] for v in gate["verdicts"]] == [
        "golden_canary", "profile_parity", "auc_floor"]
          and not any(v["skipped"] for v in gate["verdicts"]),
          f"lifecycle: (a) GATE {gate}")
    log(f"lifecycle: (a) GATE passed: {lc_verdicts(gate)}")
    want = metrics.ensemble_average(list(engine.member_probs(
        fixed, _gen=ctl._candidate)))
    with engine.make_batcher() as batcher, LcClient(batcher, fixed) as client:
        for _ in range(3):
            ctl.step()
    tl = lc_timeline(ctl)
    check(tl["states"] == LC_STATES + ["COMMIT"],
          f"lifecycle: (a) went {tl['states']}")
    check(tl["shadow_requests"] >= LC_SHADOW_REQUESTS,
          f"lifecycle: (a) the shadow counted {tl['shadow_requests']} "
          f"requests, want >= {LC_SHADOW_REQUESTS} (a timed-out window)")
    check(not client.failures and client.ok > 0,
          f"lifecycle: (a) {client.ok} client requests, failures "
          f"{client.failures[:3]}")
    check(ctl.journal.read_live() == cand and engine.generation == 1,
          f"lifecycle: (a) live pointer {ctl.journal.read_live()}, "
          f"generation {engine.generation}")
    got = engine.probs(fixed)
    check(np.array_equal(got, want), "lifecycle: (a) probabilities after the "
          "swap differ from the candidate's before it: max "
          f"{float(np.max(np.abs(got - want)))}")
    counts = lc_part_counts(lc, "a", out, {
        "fused_color_jitter": LC_K * LC_RETRAIN_STEPS,
        "fused_normalize_color_jitter": 0, "fused_adamw_update": 0},
        lc_fit_chunks(cfg, cand))
    out["cycles"]["a"] = {**tl, "retrain_s": retrain_s,
                          "client_requests": client.ok}
    out["cand_a"] = cand
    log(f"lifecycle: (a) COMMIT: {tl}; retrain of {LC_K} members x "
        f"{LC_RETRAIN_STEPS} steps {retrain_s:.1f} s; {client.ok} client "
        f"requests, none failed; probabilities after the swap bitwise the "
        f"candidate's; launches {counts} for {out['chunks']['a']} chunks "
        f"({smi})")


def lc_rejected_cycle(torch, lc: dict, root: Path, seed: int,
                      out: dict) -> None:
    """(b) freshly initialised members against a canary bound of 1e-6:
    GATE rejects, ROLLBACK with nothing swapped, live scores unchanged."""
    import numpy as np

    from jama16_retina_tpu_torch import configs

    fresh = save_random_members(torch, lc["cfg"], root / "fresh",
                                seed + 800, LC_K)
    cfg = configs.override(lc["cfg"], ["lifecycle.gate_canary_max_dev=1e-6"])
    engine, fixed = lc["engine"], lc["fixed"]
    before = engine.probs(fixed)
    gen = engine.generation
    lc_begin(lc)
    ctl = lc_controller(lc, cfg, retrain_fn=lambda c, r: fresh)
    with engine.make_batcher() as batcher, LcClient(batcher, fixed) as client:
        check(ctl.trigger(reason="drill_reject"), "lifecycle: (b) refused")
        end = ctl.run()
    gate = ctl.journal.find("GATE")
    rb = ctl.journal.find("ROLLBACK")
    check(end == "ROLLBACK" and not gate["passed"]
          and not gate["verdicts"][0]["passed"]
          and rb["cause"] == "gate_rejected" and rb["swapped"] is False,
          f"lifecycle: (b) ended {end}: {gate}, {rb}")
    check(engine.generation == gen and np.array_equal(engine.probs(fixed),
                                                      before),
          "lifecycle: (b) the rejected cycle moved the live model")
    check(not client.failures and client.ok > 0,
          f"lifecycle: (b) {client.ok} client requests, failures "
          f"{client.failures[:3]}")
    counts = lc_part_counts(lc, "b", out, {
        "fused_color_jitter": 0, "fused_normalize_color_jitter": 0,
        "fused_adamw_update": 0})
    out["cycles"]["b"] = {**lc_timeline(ctl), "client_requests": client.ok}
    log(f"lifecycle: (b) ROLLBACK (gate_rejected, swapped false): "
        f"{lc_verdicts(gate)}; live probabilities bitwise unchanged; "
        f"{client.ok} client requests, none failed; launches {counts}")


def lc_regression_cycle(torch, lc: dict, smi: str, out: dict) -> None:
    """(c) a fused retrain (B2 and B3 each step), promote, then a watch
    rule that holds -> ROLLBACK through the retained generation."""
    import numpy as np

    from jama16_retina_tpu_torch import configs
    from jama16_retina_tpu_torch.obs import quality

    cfg = configs.override(lc["cfg"], [
        "train.use_pallas_fused=true",
        f"lifecycle.watch_rules=quality.canary_ok < 1,{LC_GAUGE} > 0"])
    engine, reg, fixed = lc["engine"], lc["reg"], lc["fixed"]
    before = engine.probs(fixed)
    ref = np.array(engine.quality.canary.reference)
    rollbacks = reg.counter("serve.rollbacks").value
    lc_begin(lc)
    ctl = lc_controller(lc, cfg)
    ctl.trigger(reason="drill_regression")
    t0 = time.perf_counter()
    ctl.step()
    retrain_s = time.perf_counter() - t0
    ctl.step()
    gate = ctl.journal.find("GATE")
    check(gate["passed"], f"lifecycle: (c) GATE {gate}")
    log(f"lifecycle: (c) GATE passed: {lc_verdicts(gate)}")
    with engine.make_batcher() as batcher, LcClient(batcher, fixed) as client:
        ctl.step()
        check(ctl.state == "STAGED_ROLLOUT", f"lifecycle: (c) at {ctl.state}")
        reg.gauge(LC_GAUGE).set(1.0)
        ctl.step()
        ctl.step()
    reg.gauge(LC_GAUGE).set(0.0)
    watch, rb = ctl.journal.find("WATCH"), ctl.journal.find("ROLLBACK")
    check(ctl.state == "ROLLBACK" and watch["fired"] == [f"{LC_GAUGE}>0"]
          and rb["cause"] == "watch_regression" and rb["swapped"],
          f"lifecycle: (c) {watch}, {rb}")
    check(reg.counter("serve.rollbacks").value == rollbacks + 1
          and rb["restored_generation"] == engine.generation,
          "lifecycle: (c) the rollback did not re-swap the retained "
          "generation")
    check(np.array_equal(engine.probs(fixed), before),
          "lifecycle: (c) probabilities after the rollback differ from "
          "before the cycle")
    _, on_disk = quality.load_canary_file(lc["canary_path"])
    check(np.array_equal(engine.quality.canary.reference, ref)
          and np.array_equal(on_disk, ref),
          "lifecycle: (c) the canary reference was not restored")
    check(not client.failures, f"lifecycle: (c) client failures "
          f"{client.failures[:3]}")
    steps = LC_K * LC_RETRAIN_STEPS
    out["cand_c"] = ctl.journal.find("RETRAIN")["member_dirs"]
    counts = lc_part_counts(lc, "c", out, {
        "fused_color_jitter": 0, "fused_normalize_color_jitter": steps,
        "fused_adamw_update": steps}, lc_fit_chunks(cfg, out["cand_c"]))
    tl = lc_timeline(ctl)
    out["cycles"]["c"] = {**tl, "retrain_s": retrain_s,
                          "client_requests": client.ok}
    log(f"lifecycle: (c) ROLLBACK (watch_regression, {watch['fired']}) "
        f"through the retained generation -> generation {engine.generation}: "
        f"{tl}; fused retrain {retrain_s:.1f} s; probabilities bitwise "
        f"those before the cycle, canary reference and artifact restored; "
        f"launches {counts} ({smi})")


def lc_cli(lc: dict, root: Path, smi: str, out: dict) -> None:
    """(d) ``lifecycle_run --trigger``, then ``--watch`` killed with SIGKILL
    once member_00's marker exists, then ``--watch`` again to COMMIT, each
    a process of its own; then ``--status --json`` (journal only) in this
    one."""
    import contextlib
    import io
    import signal

    wd = root / "cli"
    canary = root / "cli_canary.npz"
    shutil.copyfile(lc["canary_path"], canary)
    shutil.copyfile(lc["canary_path"] + ".seal.json", str(canary)
                    + ".seal.json")
    sets = [s for s in lc["sets"] if not s.startswith(
        "obs.quality.canary_path=")] + [
        f"obs.quality.canary_path={canary}",
        # No live traffic reaches these processes: the shadow window
        # promotes at once, on no evidence.
        "lifecycle.shadow_wait_s=0"]
    cli = [sys.executable, "-m", "jama16_retina_tpu_torch.lifecycle_run",
           "--workdir", str(wd), "--config", "eyepacs_binary",
           *[a for s in sets for a in ("--set", s)]]
    watch = [*cli, "--watch", "--max_cycles", "1", "--poll_s", "0.5",
             "--data_dir", str(lc["data"]), "--ckpt", *lc["live"]]
    t0 = time.perf_counter()
    res = subprocess.run([*cli, "--trigger", "drill", "--ckpt", *lc["live"]],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    check(res.returncode == 0 and "cycle 0 opened" in res.stdout,
          f"lifecycle: (d) --trigger exited {res.returncode}: "
          f"{res.stdout[-500:]} {res.stderr[-1500:]}")
    cand = wd / "lifecycle" / "candidate-0000"
    marker0, marker1 = (cand / "member_00" / "RETRAIN_DONE.json",
                        cand / "member_01" / "RETRAIN_DONE.json")
    errlog = root / "cli_watch.stderr"
    with open(errlog, "w") as errf:
        child = subprocess.Popen(watch, cwd=ROOT, stdout=subprocess.DEVNULL,
                                 stderr=errf, start_new_session=True)
    try:
        while (time.perf_counter() - t0 < 400 and child.poll() is None
               and not marker0.exists()):
            time.sleep(0.05)
        check(marker0.exists() and child.poll() is None,
              f"lifecycle: (d) the --watch child exited {child.poll()} "
              f"before member_00's marker: {errlog.read_text()[-2000:]}")
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        reaped = reap_session(child.pid)
    killed_s = time.perf_counter() - t0
    check(child.returncode == -signal.SIGKILL and not marker1.exists(),
          f"lifecycle: (d) the child exited {child.returncode}; member_01 "
          f"marker exists: {marker1.exists()}")
    bytes0 = marker0.read_bytes()
    member1_ckpt = (cand / "member_01" / "latest").is_dir()
    res = subprocess.run(watch, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    check(res.returncode == 0 and "cycle 0 -> COMMIT" in res.stdout,
          f"lifecycle: (d) the rerun exited {res.returncode}: "
          f"{res.stdout[-1000:]} {res.stderr[-2000:]}")
    check(marker0.read_bytes() == bytes0 and marker1.exists(),
          "lifecycle: (d) member_00 was fitted again, or member_01 not")
    from jama16_retina_tpu_torch import lifecycle_run

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = lifecycle_run.main([*cli[3:], "--status", "--json"])
    status = json.loads(printed.getvalue())
    states = [e["state"] for e in status["timeline"]]
    check(rc == 0 and status["state"] == "COMMIT"
          and status["cycle"] == 0 and states == LC_STATES + ["COMMIT"]
          and status["live_member_dirs"] == [str(cand / f"member_{m:02d}")
                                             for m in range(LC_K)],
          f"lifecycle: (d) --status --json: {status}")
    t = [e["t"] for e in status["timeline"]]
    out["cycles"]["d"] = {"states": states,
                          "trigger_to_end_s": round(t[-1] - t[0], 3),
                          "killed_after_s": killed_s,
                          "wall_s": time.perf_counter() - t0}
    log(f"lifecycle: (d) --trigger, --watch SIGKILLed {killed_s:.1f} s in "
        f"with member_00 durable (its session's {reaped}; member_01 had "
        f"{'a' if member1_ckpt else 'no'} checkpoint), the rerun resumed at "
        f"member_01 to COMMIT, member_00's marker bytes unchanged; "
        f"--status --json: cycle 0 {states}; "
        f"{time.perf_counter() - t0:.1f} s ({smi})")


def lc_faults(torch, lc: dict, out: dict) -> None:
    """(e) a ``lifecycle.gate`` plan fails GATE closed -> ROLLBACK; a
    ``lifecycle.swap`` plan holds the journal at GATE with the old model
    serving and its canary reference in place, and the rerun commits."""
    import numpy as np

    from jama16_retina_tpu_torch.obs import faultinject

    cfg, engine, fixed = lc["cfg"], lc["engine"], lc["fixed"]
    cand = out["cand_c"]
    before = engine.probs(fixed)
    gen = engine.generation
    lc_begin(lc)
    faultinject.arm({"lifecycle.gate": {
        "kind": "error", "on_calls": [1], "error": "RuntimeError",
        "message": "gate drill"}})
    try:
        ctl = lc_controller(lc, cfg, retrain_fn=lambda c, r: cand)
        ctl.trigger(reason="drill_gate")
        end = ctl.run()
    finally:
        faultinject.disarm()
    gate = ctl.journal.find("GATE")
    check(end == "ROLLBACK" and gate["verdicts"][0]["name"] == "gate_error"
          and "gate drill" in gate["verdicts"][0]["detail"]
          and engine.generation == gen
          and np.array_equal(engine.probs(fixed), before),
          f"lifecycle: (e) the gate plan ended {end}: {gate}")
    log(f"lifecycle: (e) lifecycle.gate plan: GATE failed closed "
        f"({gate['verdicts'][0]['detail']}) -> ROLLBACK, live unchanged")

    ref = np.array(engine.quality.canary.reference)
    faultinject.arm({"lifecycle.swap": {
        "kind": "error", "on_calls": [1], "error": "RuntimeError",
        "message": "swap drill"}})
    try:
        ctl = lc_controller(lc, cfg, retrain_fn=lambda c, r: cand)
        ctl.trigger(reason="drill_swap")
        ctl.step()
        ctl.step()
        try:
            ctl.step()
            raised = None
        except RuntimeError as e:
            raised = str(e)
    finally:
        faultinject.disarm()
    check(raised is not None and "swap drill" in raised
          and ctl.state == "GATE" and engine.generation == gen
          and engine.shadow_report() is None
          and np.array_equal(engine.probs(fixed), before)
          and np.array_equal(engine.quality.canary.reference, ref),
          f"lifecycle: (e) the swap plan raised {raised!r}, left "
          f"{ctl.state}, generation {engine.generation}")
    log(f"lifecycle: (e) GATE passed before the swap plan fired: "
        f"{lc_verdicts(ctl.journal.find('GATE'))}")
    with engine.make_batcher() as batcher, LcClient(batcher, fixed) as client:
        end = ctl.run()
    tl = lc_timeline(ctl)
    check(end == "COMMIT" and ctl.journal.read_live() == cand
          and engine.generation == gen + 1
          and tl["shadow_requests"] >= LC_SHADOW_REQUESTS
          and not client.failures,
          f"lifecycle: (e) the rerun after the swap plan ended {end}: {tl}, "
          f"client failures {client.failures[:3]}")
    counts = lc_part_counts(lc, "e", out, {
        "fused_color_jitter": 0, "fused_normalize_color_jitter": 0,
        "fused_adamw_update": 0})
    out["cycles"]["e"] = tl
    log(f"lifecycle: (e) lifecycle.swap plan: raised at STAGED_ROLLOUT, "
        f"journal held at GATE, generation {gen} kept serving bitwise, "
        f"canary reference unchanged; the rerun committed {tl}; launches "
        f"{counts}")


def phase_lifecycle(torch, seed: int, smi: str, data: Path) -> dict:
    """The lifecycle controller and ``lifecycle_run`` at full width (phase
    21 of the docstring), on phase 6's splits ``data``."""
    t_phase = time.perf_counter()
    root = SCRATCH / "lifecycle"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = {"launches": {}, "wall_s": {}, "chunks": {}, "cycles": {}}
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    # The reload's canary gate compares exactly: the promote re-pins the
    # canary through the candidate handle and the swap scores it again on
    # the promoted generation, so both must pick the same algorithms.
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    torch.cuda.reset_peak_memory_stats()
    try:
        with HbmPart("setup", "live members, canary, profile and engine",
                     out, "lifecycle"):
            lc = lc_setup(torch, seed, data, root, smi)
        with HbmPart("a", "a good cycle in process", out, "lifecycle"):
            lc_good_cycle(torch, lc, smi, out)
        with HbmPart("b", "a cycle rejected at GATE", out, "lifecycle"):
            lc_rejected_cycle(torch, lc, root, seed, out)
        with HbmPart("c", "a regression after the swap", out, "lifecycle"):
            lc_regression_cycle(torch, lc, smi, out)
        with HbmPart("d", "kill -9 and resume through the CLI", out,
                     "lifecycle"):
            lc_cli(lc, root, smi, out)
        with HbmPart("e", "the lifecycle fault sites", out, "lifecycle"):
            lc_faults(torch, lc, out)
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        b4 = sum(c["fused_serve_preprocess"]
                 for k, c in out["launches"].items())
        check(b4 == sum(out["chunks"].values()),
              f"lifecycle: B4 launched {b4} times for "
              f"{sum(out['chunks'].values())} chunks")
        out["b4"] = b4
        log(f"lifecycle: peak device memory {out['peak_bytes']} bytes; B4 "
            f"{b4} launches for the phase's {sum(out['chunks'].values())} "
            f"chunks; cycles {out['cycles']} ({smi})")
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
        lc = None
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# Phase 22: data-parallel training over two ranks sharing the card.
DP_RANKS = 2
DP_STEP_BATCH = 4
DP_FIT_STEPS = 6
DP_FIT_EVAL_EVERY = 3
DP_CUT_CALL = 4
DP_FUSED_STEPS = 4
DP_STEP_BOUND = 1e-6
DP_LAUNCH_S = 300
# What a rank of (a) runs: ``dp_rank_main`` in this file.
_DP_RANK = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "sys.exit(chip_smoke.dp_rank_main(sys.argv[2:]))")
# What a rank of (b) and (c) runs under torch.distributed.run: the train
# CLI, behind cuDNN's deterministic algorithms (a resumed run is held
# bitwise to the uncut one) and a record of the rank's launches and of
# its replica's hash after every step (``dp_train_rank``).
_DP_TRAIN = """import sys

if __name__ == "__main__":
    sys.path.insert(0, {root!r})
    import chip_smoke

    sys.exit(chip_smoke.dp_train_rank(sys.argv[1:]))
"""


def replica_hash(torch, model) -> str:
    """Two sums over the 32-bit words of every parameter and buffer of
    ``model`` (plain and position-weighted), on its device: equal
    replicas give equal hashes, and a replica off by one bit does not."""
    words = torch.cat([t.detach().contiguous().reshape(-1).view(torch.int32)
                       for t in (*model.parameters(), *model.buffers())])
    words = words.long()
    weights = torch.arange(1, words.numel() + 1, device=words.device) % 65521
    return f"{int((words * weights).sum()):x}-{int(words.sum()):x}"


def dp_step(torch, form: str, seed: int, mesh=None) -> dict:
    """Phase 22 (a): one ``eyepacs_binary`` step of batch ``DP_STEP_BATCH``
    at 299 px in ``form`` on ``mesh``'s ranks (each on its block) or, with
    no mesh, on one process, in two halves: the forward and backward of
    ``train_lib.compute_grads`` in float64, heads included (B1 or B2 on
    the rank's rows, dropout on; the cross-replica BatchNorm moments and
    the gradient mean across ranks), then the step's update
    (``train_lib._update``: plain AdamW or B3) of the float32 masters from
    those gradients rounded to float32. A float32 head would leave the
    gradients 1e-7 apart, which AdamW turns into 1e-4 on a leaf whose
    gradients sit near its eps. Returns the loss, the gradients, the
    running statistics, the updated params and the replica's hash."""
    from jama16_retina_tpu_torch import configs, models, train_lib
    from jama16_retina_tpu_torch.data import synthetic
    from jama16_retina_tpu_torch.models import common, inception_v3, init
    from jama16_retina_tpu_torch.parallel import mesh as mesh_lib

    cfg = configs.override(configs.get_config("eyepacs_binary"), [
        f"data.batch_size={DP_STEP_BATCH}", f"train.seed={seed}",
        *TRAIN_FORMS[form]])
    dev = torch.device("cuda", 0) if mesh is None else mesh.device
    base = init.init_flax_default(models.build(cfg.model), seed)
    m = cfg.model
    twin = inception_v3.InceptionV3(
        num_classes=m.num_classes, aux_head=m.aux_head,
        dropout_rate=m.dropout_rate, dtype=torch.float64,
        image_size=m.image_size)
    twin.load_state_dict(base.state_dict())
    twin = twin.to(torch.float64)
    for mod in twin.modules():
        if isinstance(mod, common.BatchNorm) and mesh is not None:
            mod.mesh = mesh
    images, grades = synthetic.make_dataset(
        DP_STEP_BATCH, synthetic.SynthConfig(image_size=299), seed=seed + 22)
    batch = {"image": torch.from_numpy(images),
             "grade": torch.from_numpy(grades)}
    batch = (mesh_lib.shard_batch(batch, mesh) if mesh is not None
             else {k: v.to(dev) for k, v in batch.items()})
    state64 = train_lib.create_state(cfg, twin, dev)
    # The heads' spatial mean kept in float64 (the model rounds it to
    # float32, as the Flax heads compute).
    head_mean = inception_v3.head_mean
    inception_v3.head_mean = lambda x: x.mean(dim=(2, 3))
    try:
        loss, grads = train_lib.compute_grads(state64, batch, cfg,
                                              mesh=mesh)
    finally:
        inception_v3.head_mean = head_mean
    state = train_lib.create_state(cfg, base, dev)
    params = dict(state.model.named_parameters())
    train_lib._update(state, params, [g.float() for g in grads], cfg.train,
                      lead=0)
    torch.cuda.synchronize(dev)
    return {"loss": float(loss),
            "grads": dict(zip(params, (g.detach() for g in grads))),
            "stats": dict(state64.model.named_buffers()),
            "params": {k: p.detach() for k, p in params.items()},
            "hash": replica_hash(torch, state.model)}


def worst_leaf(torch, got: dict, want: dict) -> "tuple[str, float]":
    """The leaf of largest relative L2 gap (in float64), and the gap."""
    gaps = {k: float((got[k].double() - want[k].double()).norm()
                     / max(float(want[k].double().norm()), 1e-30))
            for k in want}
    k = max(gaps, key=gaps.get)
    return k, gaps[k]


def dp_rank_main(argv) -> int:
    """One rank of phase 22 (a), on the card under the launch's group
    (argv: the output directory, the seed). Each form: the two-rank step
    (its launch counts read just after it), then, on rank 0, the
    one-process step on the whole batch and the gaps. Writes
    ``rank<r>.json``."""
    import torch

    from jama16_retina_tpu_torch.parallel import mesh as mesh_lib

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out_dir, seed = Path(argv[0]), int(argv[1])
    mesh_lib.initialize_distributed()
    mesh = mesh_lib.make_mesh()
    res = {"rank": mesh.rank, "backend": mesh.backend,
           "device": str(mesh.device), "forms": {}}
    for form in TRAIN_FORMS:
        reset_launch_counts()
        got = dp_step(torch, form, seed, mesh)
        rec = {"counts": launch_counts(), "hash": got["hash"],
               "loss": got["loss"]}
        if mesh.rank == 0:
            want = dp_step(torch, form, seed)
            rec["loss_diff"] = abs(got["loss"] - want["loss"])
            for part in ("grads", "stats", "params"):
                rec[f"{part}_worst"] = worst_leaf(torch, got[part],
                                                  want[part])
            del want
        del got
        torch.cuda.empty_cache()
        mesh.barrier()
        res["forms"][form] = rec
    (out_dir / f"rank{mesh.rank}.json").write_text(json.dumps(res))
    torch.distributed.destroy_process_group()
    return 0


def dp_train_rank(argv) -> int:
    """One rank of a launch of phase-22 fits. ``argv`` holds one or more
    runs, each ``--dp_run NAME`` and then the train CLI's arguments, run in
    turn through ``jama16_retina_tpu_torch.train.main`` in one process
    group, formed here once (a group formed anew in the same processes
    timed out in gloo's connect on the card), with cuDNN deterministic,
    each step followed by its replica's hash. Each run's launch counts,
    hashes, backend, device and error go to ``$DP_OUT/NAME.rank<r>.json``.
    A run that raises is recorded and ends the rank's runs, with exit code
    0: the records carry the outcome (a rank that exits non-zero has the
    launcher stop the other before it writes)."""
    import os

    import torch

    from jama16_retina_tpu_torch import train, train_lib
    from jama16_retina_tpu_torch.parallel import mesh as mesh_lib

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    rank = int(os.environ["RANK"])
    runs, name = {}, None
    for a in argv:
        if name == "":
            name = a
            runs[name] = []
        elif a == "--dp_run":
            name = ""
        else:
            runs[name].append(a)
    step = train_lib.train_step
    rec: dict = {}

    def hashed_step(state, batch, cfg, *args, **kwargs):
        loss = step(state, batch, cfg, *args, **kwargs)
        rec["hashes"].append(replica_hash(torch, state.model))
        rec["backend"] = torch.distributed.get_backend()
        rec["device"] = str(state.sched_count.device)
        return loss

    train_lib.train_step = hashed_step
    mesh_lib.initialize_distributed()
    try:
        for name, run_argv in runs.items():
            rec.clear()
            rec.update(rank=rank, hashes=[], error=None)
            reset_launch_counts()
            try:
                train.main(run_argv)
            except Exception as e:  # noqa: BLE001 - recorded for the phase
                rec["error"] = f"{type(e).__name__}: {e}"
            rec["counts"] = launch_counts()
            Path(os.environ["DP_OUT"], f"{name}.rank{rank}.json").write_text(
                json.dumps(rec))
            if rec["error"] is not None:
                break
    finally:
        torch.distributed.destroy_process_group()
    return 0


def descendants(pid: int) -> "list[int]":
    """The live processes below ``pid`` (from ``/proc``), whatever their
    session."""
    import os

    parent = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                parent[int(d)] = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
    below, frontier = [], [pid]
    while frontier:
        p = frontier.pop()
        kids = [c for c, pp in parent.items() if pp == p]
        below += kids
        frontier += kids
    return below


def dp_launch(cmd, env: dict, what: str) -> "subprocess.CompletedProcess":
    """Run a launch of ranks in a session of its own, at most
    ``DP_LAUNCH_S``; whatever it leaves (its ranks, their reader
    processes) is stopped before this returns. Prints its start and end."""
    import os

    import os
    import signal

    log(f"dp: {what}: start")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=DP_LAUNCH_S)
    except subprocess.TimeoutExpired:
        # The launcher starts its ranks in sessions of their own: stop
        # every process below it, then what its session left.
        below = descendants(proc.pid)
        for pid in below:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        log(f"dp: {what}: over {DP_LAUNCH_S} s; {len(below)} process(es) "
            f"below the launcher killed; {reap_session(proc.pid)}")
        out, err = proc.communicate()
    reaped = session_members(proc.pid)
    if reaped:
        log(f"dp: {what}: {reap_session(proc.pid)}")
    log(f"dp: {what}: end, exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s")
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def dp_check_exit(run: dict, ok: bool, msg: str) -> None:
    """``check`` of a launch's outcome, with the end of its errors printed
    when it fails."""
    if not ok:
        print(run["stderr"][-4000:], file=sys.stderr, flush=True)
    check(ok, msg)


def dp_launch_fits(root: Path, data: Path, what: str, runs: dict
                   ) -> "subprocess.CompletedProcess":
    """Fits of the train CLI over ``DP_RANKS`` ranks on the card, in turn in
    one ``python -m torch.distributed.run`` (``_DP_TRAIN`` around
    ``jama16_retina_tpu_torch.train``): ``runs`` maps a name to its
    ``--set`` items (the workdir is ``wd/<name before "_">``)."""
    import os

    wrapper = root / "dp_train.py"
    wrapper.write_text(_DP_TRAIN.format(root=str(ROOT)))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(DP_RANKS), str(wrapper)]
    for name, sets in runs.items():
        cmd += ["--dp_run", name, "--config", "eyepacs_binary",
                "--data_dir", str(data),
                "--workdir", str(root / "wd" / name.split("_")[0]),
                "--set", f"parallel.num_devices={DP_RANKS}",
                "--set", f"data.batch_size={TRAIN_BATCH}",
                "--set", "train.log_every=1",
                *[a for x in sets for a in ("--set", x)]]
    return dp_launch(cmd, {**os.environ, "DP_OUT": str(root)}, what)


def dp_read_fits(root: Path, what: str, names: list,
                 done: "subprocess.CompletedProcess") -> dict:
    """What a launch of fits left: name -> the ranks' records, rank 0's
    metrics records and the last line it printed for that fit; and the
    launch's exit code and errors."""
    from jama16_retina_tpu_torch.utils.logging import read_jsonl

    printed = [line for line in done.stdout.splitlines()
               if line.startswith('{"config"')]
    out = {"code": done.returncode, "stderr": done.stderr}
    for name in names:
        ranks = []
        for r in range(DP_RANKS):
            path = root / f"{name}.rank{r}.json"
            dp_check_exit(out, path.exists(),
                          f"dp: {what}: rank {r} wrote no record of {name}")
            ranks.append(json.loads(path.read_text()))
        wd = root / "wd" / name.split("_")[0]
        metrics = wd / "metrics.jsonl"
        ok = ranks[0]["error"] is None
        out[name] = {"ranks": ranks, "wd": wd,
                     "records": (read_jsonl(str(metrics))
                                 if metrics.exists() else []),
                     "last": printed.pop(0) if ok and printed else ""}
    return out


def dp_fits(root: Path, data: Path, what: str, runs: dict) -> dict:
    """``dp_launch_fits`` and then ``dp_read_fits``."""
    return dp_read_fits(root, what, list(runs),
                        dp_launch_fits(root, data, what, runs))


def dp_counts(run: dict) -> dict:
    """A launch's counts, summed over its ranks."""
    total = dict.fromkeys(run["ranks"][0]["counts"], 0)
    for r in run["ranks"]:
        for k, v in r["counts"].items():
            total[k] += v
    return total


def dp_check_fit(run: dict, name: str, steps: int, kernels: dict) -> None:
    """Each rank ran ``steps`` steps with equal replica hashes after every
    one, on the card under gloo, and launched ``kernels`` (per rank)."""
    ranks = run["ranks"]
    hashes = [r["hashes"] for r in ranks]
    check(all(len(h) == steps for h in hashes) and all(
        len(set(step)) == 1 for step in zip(*hashes)),
        f"dp: {name}: replica hashes differ or miss steps: {hashes}")
    for r in ranks:
        check(r["backend"] == "gloo" and r["device"] == "cuda:0",
              f"dp: {name}: rank {r['rank']} ran on {r['device']} under "
              f"{r['backend']}, want cuda:0 under gloo (two ranks, one card)")
        want = {**dict.fromkeys(r["counts"], 0), **kernels}
        check(r["counts"] == want,
              f"dp: {name}: rank {r['rank']} launched {r['counts']}, want "
              f"{want}")


def dp_step_ms(records) -> float:
    """Median step of a fit's train records (log_every 1) with no eval or
    save in its window, after the first."""
    return statistics.median(
        1e3 * r["window_sec"] for r in records
        if r["kind"] == "train" and r["step"] > 1 and r["pause_sec"] == 0
        and r["save_sec"] == 0)


def workdir_digest(wd: Path, sub: str) -> str:
    """sha256 over the step dirs of ``wd/sub`` (``best`` or ``latest``):
    their names and every array of their states."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for step_dir in sorted((wd / sub).iterdir(), key=lambda p: p.name):
        h.update(step_dir.name.encode())
        with np.load(step_dir / "state.npz") as f:
            for k in sorted(f.files):
                h.update(k.encode())
                h.update(np.ascontiguousarray(f[k]).tobytes())
    return h.hexdigest()


def dp_check_steps(root: Path, out: dict) -> None:
    """Phase 22 (a)'s checks, on the ranks' records in ``root``."""
    ranks = [json.loads((root / f"rank{r}.json").read_text())
             for r in range(DP_RANKS)]
    out["backend"] = ranks[0]["backend"]
    out["devices"] = [r["device"] for r in ranks]
    want = {"preset": {"fused_color_jitter": 1},
            "fused": {"fused_normalize_color_jitter": 1,
                      "fused_adamw_update": 1}}
    for form in TRAIN_FORMS:
        recs = [r["forms"][form] for r in ranks]
        for r, rec in zip(ranks, recs):
            check(r["backend"] == "gloo" and r["device"] == "cuda:0",
                  f"dp: (a) rank {r['rank']} on {r['device']} under "
                  f"{r['backend']}")
            kern = {**dict.fromkeys(rec["counts"], 0), **want[form]}
            check(rec["counts"] == kern,
                  f"dp: (a) {form}: rank {r['rank']} launched "
                  f"{rec['counts']}, want {kern}")
        check(len({rec["hash"] for rec in recs}) == 1
              and len({rec["loss"] for rec in recs}) == 1,
              f"dp: (a) {form}: the replicas differ after the step")
        lead = recs[0]
        worst = {p: lead[f"{p}_worst"] for p in ("grads", "stats", "params")}
        log(f"dp: (a) {form}: loss {lead['loss']:.9f}, |diff| to one rank "
            f"{lead['loss_diff']:.3e}; worst leaf relative L2 against one "
            f"rank: gradients (float64) {worst['grads']}, running "
            f"statistics {worst['stats']}, updated params {worst['params']} "
            f"(bound {DP_STEP_BOUND}); replica hash {lead['hash']} on both "
            f"ranks; launches per rank {lead['counts']}")
        check(lead["loss_diff"] <= DP_STEP_BOUND
              and all(w[1] <= DP_STEP_BOUND for w in worst.values()),
              f"dp: (a) {form}: 2 ranks against 1: {worst}")
        out["launches"][f"dp_step_{form}"] = {
            k: sum(rec["counts"][k] for rec in recs)
            for k in recs[0]["counts"]}
        out[f"step_{form}"] = {"loss_diff": lead["loss_diff"], **worst}


def phase_dp(torch, seed: int, smi: str, data: Path, one_rank_ms: float
             ) -> dict:
    """Data-parallel training over two ranks sharing the card (phase 22
    of the docstring), on phase 6's splits ``data``, first part: (b)'s
    uncut fit, (c)'s fit and (b)'s fit cut at step 3, in turn in one launch
    (the first two alone on the card: their step times are printed). The
    second part (``dp_rest_start``, ``dp_rest_finish``) resumes the cut
    fit beside (a)."""
    t_phase = time.perf_counter()
    root = SCRATCH / "dp"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = {"launches": {}, "wall_s": {}, "root": root, "seed": seed,
           "data": data, "smi": smi}
    out["fit_sets"] = (f"train.steps={DP_FIT_STEPS}",
                       f"train.eval_every={DP_FIT_EVAL_EVERY}",
                       f"train.seed={seed}", "eval.sharded=true")
    cut_plan = fault_spec({"trainer.step": {
        "kind": "error", "error": "RuntimeError", "on_calls": [DP_CUT_CALL],
        "message": "dp cut"}})
    first = dp_fits(root, data, "(b) uncut, (c) fused, (b) cut", {
        "uncut": out["fit_sets"],
        "fused": (f"train.steps={DP_FUSED_STEPS}",
                  f"train.eval_every={DP_FUSED_STEPS}",
                  f"train.seed={seed}", "train.use_pallas_fused=true"),
        "cut_first": (*out["fit_sets"], cut_plan)})
    dp_check_exit(first, first["code"] == 0,
                  f"dp: the first launch exited {first['code']}")
    uncut, fused, cut = (first[k] for k in ("uncut", "fused", "cut_first"))
    for name, run in (("uncut", uncut), ("fused", fused)):
        dp_check_exit(first, all(r["error"] is None for r in run["ranks"]),
                      f"dp: the {name} fit raised "
                      f"{[r['error'] for r in run['ranks']]}")
    # (b) The uncut fit.
    dp_check_fit(uncut, "(b) uncut", DP_FIT_STEPS,
                 {"fused_color_jitter": DP_FIT_STEPS})
    recs = uncut["records"]
    evals = [r for r in recs if r["kind"] == "eval"]
    check(recs[0]["kind"] == "config" and recs[0]["n_devices"] == DP_RANKS
          and [r["step"] for r in evals] == [DP_FIT_EVAL_EVERY, DP_FIT_STEPS]
          and all(0 <= r["val_auc"] <= 1 for r in evals),
          f"dp: (b) the uncut fit's records: {recs[:1]}, {evals}")
    files = sorted(p.name for p in uncut["wd"].iterdir())
    check(not [n for n in files if ".p1" in n or "rank" in n]
          and {"metrics.jsonl", "run_meta.json", "best", "latest"}
          <= set(files), f"dp: (b) the uncut workdir holds {files}")
    b_ms = dp_step_ms(recs)
    log(f"dp: (b) {DP_FIT_STEPS}-step preset fit over {DP_RANKS} ranks: "
        f"{json.loads(uncut['last'])['results']}; launches "
        f"{dp_counts(uncut)}; replica hashes equal after each step; rank 0 "
        f"alone wrote {files}")
    # (c) The fused fit.
    dp_check_fit(fused, "(c) fused", DP_FUSED_STEPS,
                 {"fused_normalize_color_jitter": DP_FUSED_STEPS,
                  "fused_adamw_update": DP_FUSED_STEPS})
    c_ms = dp_step_ms(fused["records"])
    log(f"dp: (c) {DP_FUSED_STEPS}-step fused fit over {DP_RANKS} ranks: "
        f"launches {dp_counts(fused)}; replica hashes equal after each step")
    # (b) The fit cut at step 3.
    dp_check_exit(first, all("dp cut" in (r["error"] or "")
                             for r in cut["ranks"]),
                  f"dp: (b) the cut fit ended with "
                  f"{[r['error'] for r in cut['ranks']]}")
    dp_check_fit(cut, "(b) cut", DP_CUT_CALL - 1,
                 {"fused_color_jitter": DP_CUT_CALL - 1})
    out["launches"].update({"dp_fit": dp_counts(uncut),
                            "dp_fit_fused": dp_counts(fused),
                            "dp_fit_cut": dp_counts(cut)})
    out.update(uncut=uncut, preset_step_ms=b_ms, fused_step_ms=c_ms)
    log(f"times: phase 22: step of the global batch {TRAIN_BATCH} (16 a "
        f"rank) over {DP_RANKS} ranks, median: preset {b_ms:.1f} ms, fused "
        f"{c_ms:.1f} ms, against one rank's {one_rank_ms:.1f} ms (phase 6). "
        f"Two ranks share one card here: each runs every kernel of its half "
        f"batch, and every BatchNorm's moments and the gradient cross the "
        f"host through gloo, so the step is slower than one rank's and says "
        f"nothing of scaling over cards ({smi})")
    out["wall_s"]["first"] = time.perf_counter() - t_phase
    return out


def dp_rest_start(dp: dict) -> list:
    """Phase 22's second part, in the background: (b)'s resume from step
    3 through ``torch.distributed.run`` and, beside it, (a) on two ranks
    (``launch_local``). -> the threads, whose results ``dp_rest_finish``
    reads (nothing here checks: a check stops the main thread)."""
    import threading

    from jama16_retina_tpu_torch.parallel import mesh as mesh_lib

    log("dp: (a) one step, 2 ranks against 1, and (b)'s resume: start")
    dp["t_rest"] = time.perf_counter()
    jobs = {
        "steps": lambda: mesh_lib.launch_local(
            ["-c", _DP_RANK, str(ROOT), str(dp["root"]), str(dp["seed"])],
            DP_RANKS, timeout_s=DP_LAUNCH_S),
        "resume": lambda: dp_launch_fits(dp["root"], dp["data"],
                                         "(b) resume", {"cut_resume": (
                                             *dp["fit_sets"],
                                             "train.resume=true")})}
    threads = []
    for name, job in jobs.items():
        def run(name=name, job=job):
            try:
                dp[name] = job()
            except BaseException as e:  # noqa: BLE001 - read by the finish
                dp[name] = e
        threads.append(threading.Thread(target=run, name=f"dp-{name}"))
        threads[-1].start()
    return threads


def dp_rest_finish(torch, dp: dict, threads: list) -> dict:
    """Join phase 22's second part and check it: (a)'s records, and (b)'s
    resume against the uncut fit, bitwise."""
    for t in threads:
        t.join()
    try:
        for name in ("steps", "resume"):
            if isinstance(dp[name], BaseException):
                raise dp[name]
        log(f"dp: (a) and (b)'s resume: end, (a) exit {dp['steps']}")
        check(dp["steps"] == 0, f"dp: (a) the ranks exited {dp['steps']}")
        dp_check_steps(dp["root"], dp)
        second = dp_read_fits(dp["root"], "(b) resume", ["cut_resume"],
                              dp["resume"])
        resumed, uncut = second["cut_resume"], dp["uncut"]
        dp_check_exit(second, second["code"] == 0 and all(
            r["error"] is None for r in resumed["ranks"]),
            f"dp: (b) the resume exited {second['code']} with "
            f"{[r['error'] for r in resumed['ranks']]}")
        dp_check_fit(resumed, "(b) resumed", DP_FIT_STEPS - DP_FIT_EVAL_EVERY,
                     {"fused_color_jitter":
                      DP_FIT_STEPS - DP_FIT_EVAL_EVERY})
        check([r["step"] for r in resumed["records"]
               if r["kind"] == "resume"] == [DP_FIT_EVAL_EVERY],
              "dp: (b) the resumed run has no resume record at step "
              f"{DP_FIT_EVAL_EVERY}")
        digests = {sub: (workdir_digest(uncut["wd"], sub),
                         workdir_digest(resumed["wd"], sub))
                   for sub in ("latest", "best")}
        check(all(a == b for a, b in digests.values()),
              f"dp: (b) the resumed run's latest/ and best/ differ from the "
              f"uncut run's: {digests}")
        check(uncut["ranks"][0]["hashes"][-1]
              == resumed["ranks"][0]["hashes"][-1],
              "dp: (b) the resumed replica's hash differs from the uncut "
              "one's")
        log(f"dp: (b) cut by trainer.step at call {DP_CUT_CALL} and resumed "
            f"from {DP_FIT_EVAL_EVERY}: latest/ and best/ bitwise the uncut "
            f"run's ({digests['latest'][0][:16]}, {digests['best'][0][:16]}; "
            f"cuDNN deterministic); backend {dp['backend']}, ranks on "
            f"{dp['devices']}")
        dp["launches"]["dp_fit_resume"] = dp_counts(resumed)
        dp["wall_s"]["rest"] = time.perf_counter() - dp["t_rest"]
    finally:
        shutil.rmtree(dp["root"], ignore_errors=True)
    return dp


def memoize_init() -> None:
    """Draw each member init once. For the whole run,
    ``models.init.init_flax_default`` is replaced by a memo of it: the
    phases build their members through it (the fits, the stacked
    ensemble's members, the agreement twins, the cascade's teachers),
    many with the same layout and seed, and it draws every value in
    ``state_dict`` order from a generator seeded with the seed alone, so a
    later call with the same layout and seed gets a copy of the first
    call's values, the same bits without the second of CPU draws an
    Inception-v3 costs. The first reuse of each (seed, layout) draws
    afresh all the same and fails the run unless that draw is bitwise the
    memo's, so an init that came to depend on more than layout and seed
    would show here."""
    import torch

    from jama16_retina_tpu_torch.models import init

    draw, drawn, checked = init.init_flax_default, {}, set()

    def init_flax_default(model, seed):
        state = model.state_dict()
        key = (int(seed), tuple((k, tuple(v.shape), v.dtype, v.device.type)
                                for k, v in state.items()))
        if key not in drawn:
            draw(model, seed)
            drawn[key] = {k: v.detach().clone() for k, v in state.items()}
            return model
        if key not in checked:
            draw(model, seed)
            check(all(torch.equal(v, drawn[key][k]) for k, v in state.items()),
                  f"init_flax_default drew other values for seed {seed} "
                  "and the same layout: memoize_init's memo no longer "
                  "holds")
            checked.add(key)
            return model
        with torch.no_grad():
            for k, v in state.items():
                v.copy_(drawn[key][k])
        return model

    init.init_flax_default = init_flax_default


def kernel_record(name, source, replaces, launches, err, t) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"jama16_retina_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "below_bound": t["ms"] < t["bound_ms"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also write device-time tables of one request "
                         "and one train step of each form into DIR")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device is available",
              file=sys.stderr, flush=True)
        return 1
    try:
        from jama16_retina_tpu_torch.ops import build
        from jama16_retina_tpu_torch.ops import color_jitter as cj
        from jama16_retina_tpu_torch.ops import serve_preprocess as sp
    except ModuleNotFoundError as e:
        # Run by itself, outside a checkout of the repository.
        print(f"chip_smoke: FAIL: {e}; run it from the root of a checkout",
              file=sys.stderr, flush=True)
        return 1

    dev = torch.device("cuda", 0)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"device: {name} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    memoize_init()

    t0 = time.perf_counter()
    for src, out in build.build_all(ptxas_verbose=True).items():
        log(f"build: {build.source_path(src).name}\n{out.strip()}")
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for c in (8, 16):
        plan = cj._b2_plan(299, 299, cluster=c)
        log(f"build: B2 single pass at 299 px, cluster {c}: "
            f"{plan.shared_bytes} bytes of shared memory a block, at most "
            f"{cj.b2_max_active_clusters(plan)} clusters resident "
            "(cudaOccupancyMaxActiveClusters)")

    marks = [time.perf_counter()]

    def mark(what: str) -> None:
        """The wall time of the phases since the last mark."""
        marks.append(time.perf_counter())
        log(f"times: {what} wall {marks[-1] - marks[-2]:.1f} s (at "
            f"{marks[-1] - t_start:.1f} s) ({smi})")

    max_err = phase_kernels(torch, sp, dev, args.seed)
    jitter_err = phase_jitter_kernels(torch, dev, args.seed)
    adamw_err = phase_adamw_kernel(torch, dev, args.seed)
    mark("phase 3 (kernels)")
    serve = phase_serve(torch, args.seed)
    log(f"serve: peak device memory {torch.cuda.max_memory_allocated()} "
        f"bytes ({smi})")
    mark("phase 4 (serve)")
    train = phase_train(torch, args.seed, TRAIN_STEPS)
    batch = augmented_batch(torch, args.seed)
    phase_train_agreement(torch, args.seed, batch)
    mark("phase 5 (train, agreement)")

    timing = {b: kernel_times(torch, sp, dev, b) for b in (8, 16, 64)}
    for t in timing.values():
        log(f"times: fused_serve_preprocess {t['shape']}: device kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}){below_bound(t)}; per "
            f"call {t['call_ms']:.4f} ms, plain {t['plain_call_ms']:.4f} ms "
            f"({smi})")
    jitter = jitter_times(torch, dev)
    opt_by_set = {p: adamw_times(torch, dev, args.seed, p)
                  for p in B3_PRESETS}
    opt = opt_by_set["eyepacs_binary"]
    for t in (*opt_by_set.values(), *timing.values()):
        t["below_bound"] = t["ms"] < t["bound_ms"]
    for p, t in opt_by_set.items():
        log(f"times: fused_adamw_update {p} ({t['leaves']} leaves, "
            f"{t['elements']} elements, {t['launches_per_call']} launch(es)"
            f"): device {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}){below_bound(t)}"
            f", library {t['library_ms']:.4f} ms ({smi})")
    for kname, t in (*jitter.items(), ("fused_adamw_update", opt)):
        lib = ("" if t["library_ms"] is None
               else f", library {t['library_ms']:.4f} ms")
        log(f"times: {kname}: device {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}){below_bound(t)}{lib} ({smi})")
    b2 = jitter["fused_normalize_color_jitter"]
    log(f"times: fused_normalize_color_jitter {b2['shape']} by route, in "
        f"turns {list(B2_TURNS)}: {b2['turns_ms']} ms; kept cluster "
        f"{b2['cluster']}: {b2['ms']:.5f} ms, {100 * b2['bound_ms'] / b2['ms']:.1f} "
        f"% of the bound; two pass {b2['two_pass_ms']:.5f} ms; yardstick "
        f"images.to(float32) {b2['yardstick_ms']:.5f} ms ({smi})")
    request_times(torch, serve, smi)
    mark("phase 7 (kernel and request times)")
    knobs_serve = phase_serve_knobs(torch, args.seed, smi, serve)
    steps = train_step_times(torch, args.seed, smi)
    mark("phase 10 (serving knobs) and the train step times")
    fit = phase_fit(torch, args.seed, smi, steps["preset"]["step_ms"])
    mark("phase 6 (fit)")
    # The ranks' processes take the card beside this one's cached blocks.
    torch.cuda.empty_cache()
    dp = phase_dp(torch, args.seed, smi, fit["data"], fit["stream_step_ms"])
    mark("phase 22, first part (data-parallel: the uncut, fused and cut "
         "fits)")
    knobs = phase_knobs(torch, args.seed, smi, fit)
    t_phase = time.perf_counter()
    optimizers = phase_optimizers(torch, args.seed, smi)
    t_11 = [time.perf_counter()]
    recipe = phase_recipe(torch, args.seed, smi, fit["root"], fit["data"])
    t_11.append(time.perf_counter())
    ensemble = phase_ensemble(torch, args.seed, smi, fit["root"], fit["data"])
    log(f"times: phase 11 (optimizers, recipe, ensemble) wall "
        f"{time.perf_counter() - t_phase:.1f} s (by part "
        f"{t_11[0] - t_phase:.1f}, {t_11[1] - t_11[0]:.1f}, "
        f"{time.perf_counter() - t_11[1]:.1f}) ({smi})")
    t_phase = time.perf_counter()
    distill = phase_distill(torch, args.seed, smi, fit["root"], fit["data"])
    t_12 = time.perf_counter()
    cascade = phase_cascade(torch, args.seed, smi, fit["root"], distill)
    log(f"times: phase 12 (distill, cascade, generations) wall "
        f"{time.perf_counter() - t_phase:.1f} s (distill "
        f"{t_12 - t_phase:.1f}) ({smi})")
    router = phase_router(torch, args.seed, smi, serve, distill, cascade,
                          fit["root"])
    jpeg = phase_jpeg_host(torch, args.seed, smi, serve)
    obs = phase_obs(torch, args.seed, smi, serve, fit["data"])
    faults = phase_faults(torch, args.seed, smi, serve, router, fit["data"])
    preprocess = phase_preprocess(torch, args.seed, smi, serve)
    mark("phases 9 and 11-17")
    grain = phase_grain(torch, args.seed, smi, serve, fit["data"])
    mark(f"phase 20 (grain, progressive JPEG; by part "
         f"{ {k: round(v, 1) for k, v in grain['wall_s'].items()} })")
    lifecycle = phase_lifecycle(torch, args.seed, smi, fit["data"])
    mark(f"phase 21 (lifecycle; by part "
         f"{ {k: round(v, 1) for k, v in lifecycle['wall_s'].items()} })")
    hbm = phase_hbm(torch, args.seed, smi)
    mark(f"phase 18 (hbm; by part "
         f"{ {k: round(v, 1) for k, v in hbm['wall_s'].items()} })")
    tiered = phase_tiered(torch, args.seed, smi, hbm)
    mark(f"phase 19 (tiered, rawshard, autotune; by part "
         f"{ {k: round(v, 1) for k, v in tiered['wall_s'].items()} })")
    torch.cuda.empty_cache()
    for form, t in train.items():
        log(f"times: train {form}: peak device memory {t['peak']} bytes "
            f"({smi})")
    # Phase 22's second part runs beside phase 8, whose checks read no
    # clock.
    dp_threads = dp_rest_start(dp)
    model_runs = {}
    for preset in MODEL_PRESETS:
        t_model = [time.perf_counter()]
        # 1 row and 13 (the partial chunk) against the CPU; the time
        # limit leaves the 8-row request to the card alone here.
        srv = phase_serve(torch, args.seed, preset, cpu_rows=(1, 13))
        t_model.append(time.perf_counter())
        model_runs[f"serve_{preset}"] = srv["launches"]
        del srv
        torch.cuda.empty_cache()
        for form, t in phase_train(torch, args.seed, MODEL_STEPS,
                                   preset).items():
            model_runs[f"train_{preset}_{form}"] = t["launches"]
        t_model.append(time.perf_counter())
        phase_train_agreement(torch, args.seed, batch, preset, ("float64",))
        torch.cuda.empty_cache()
        t_model.append(time.perf_counter())
        parts = [round(b - a, 1) for a, b in zip(t_model, t_model[1:])]
        log(f"times: {preset} serve, train and agreement wall "
            f"{t_model[-1] - t_model[0]:.1f} s (serve, train, agreement: "
            f"{parts}) ({smi})")
    mark("phase 8 (resnet50, efficientnet_b4, icdr5), beside phase 22's "
         "second part")
    dp_rest_finish(torch, dp, dp_threads)
    shutil.rmtree(fit["root"], ignore_errors=True)
    mark(f"phase 22, second part (the resume beside (a), from phase 8's "
         f"start; by part "
         f"{ {k: round(v, 1) for k, v in dp['wall_s'].items()} })")
    if args.profile:
        profile_request(torch, serve, args.profile)
        profile_train(torch, steps, args.profile)

    main_row = timing[8]
    # Each kernel's launches on this slice's path, phase 21: B1 in (a)'s
    # preset retrain, B2 and B3 in (c)'s fused one, B4 in every chunk the
    # phase's engine served or scored.
    lc_runs = lifecycle["launches"]
    b4 = kernel_record(
        "fused_serve_preprocess", "serve_preprocess.cu",
        "jama16_retina_tpu/ops/pallas_serve.py:143", lifecycle["b4"],
        max_err, {**main_row, "library_ms": None})
    b4.update({"max_abs_diff": max_err, "timed_shape": main_row["shape"],
               "by_batch": {str(b): t for b, t in timing.items()}})
    # Phase 22's added, summed over its ranks: B1 in (b)'s uncut fit, B2
    # and B3 in (c)'s fused one.
    dp_runs = dp["launches"]
    launches = {"fused_color_jitter":
                lc_runs["lifecycle_a"]["fused_color_jitter"]
                + dp_runs["dp_fit"]["fused_color_jitter"],
                **{k: lc_runs["lifecycle_c"][k] + dp_runs["dp_fit_fused"][k]
                   for k in ("fused_normalize_color_jitter",
                             "fused_adamw_update")}}
    for ph, runs_of in (("18", hbm), ("19", tiered), ("20", grain),
                        ("21", lifecycle), ("22", dp)):
        log(f"launches: phase {ph}: {runs_of['launches']}")
    # Each path's counts, all four set to 0 just before it ran and read
    # just after.
    runs = {"serve": serve["launches"],
            **{f"train_{form}": t["launches"] for form, t in train.items()},
            **{f"fit_{run}": n for run, n in fit["launches"].items()},
            **knobs["launches"], **model_runs,
            "serve_knobs": knobs_serve["launches"],
            **optimizers["launches"], **recipe["launches"],
            **ensemble["launches"], **distill["launches"],
            **cascade["launches"], **router["launches"],
            **jpeg["launches"], **obs["launches"], **faults["launches"],
            **preprocess["launches"], **hbm["launches"],
            **tiered["launches"], **grain["launches"], **lc_runs,
            **dp_runs}
    by_phase = {k: {run: counts[k] for run, counts in runs.items()}
                for k in launch_counts()}
    records = [
        kernel_record("fused_color_jitter", "color_jitter.cu",
                      "jama16_retina_tpu/ops/pallas_augment.py:61",
                      launches["fused_color_jitter"],
                      jitter_err["fused_color_jitter"],
                      jitter["fused_color_jitter"]),
        {**kernel_record("fused_normalize_color_jitter", "color_jitter.cu",
                         "jama16_retina_tpu/ops/pallas_augment.py:200",
                         launches["fused_normalize_color_jitter"],
                         jitter_err["fused_normalize_color_jitter"], b2),
         **{k: b2[k] for k in ("plan_route", "cluster", "two_pass_ms",
                               "yardstick_ms", "turns_ms")}},
        {**kernel_record("fused_adamw_update", "adamw.cu",
                         "jama16_retina_tpu/ops/pallas_opt.py:105",
                         launches["fused_adamw_update"], adamw_err, opt),
         "by_leaf_set": opt_by_set},
        b4,
    ]
    for r in records:
        r["launches_by_phase"] = by_phase[r["name"]]
    log(json.dumps({"kernels": records}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
