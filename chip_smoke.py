#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's retrieve-then-rerank path on one GPU, in
bf16 and with the int8 serving knobs on.

Run from the repository root: ``python3 chip_smoke.py``. Needs one CUDA
card, ``nvcc`` and the port package beside this file; imports no JAX.

Phases, each printing one JSON line with its elapsed seconds:
  0. the card (name and power limit as ``nvidia-smi`` gives them);
  1. build the CUDA kernels (``nvcc`` -> shared library -> ``ctypes``), and
     report each library's registers, static shared memory and spill bytes
     from its ``-Xptxas -v`` log (and each instance of K2's generic kernel on
     a line of its own); K2's fp32 library must hold TF32 tensor-core
     instructions (``HMMA ... TF32`` in ``cuobjdump -sass``) and ``cp.async``
     copies (``LDGSTS``), its generic kernel's libraries bf16
     (``attention_any``) and TF32 (``attention_any_f32``) ones and
     ``LDGSTS``;
  2. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes (K1 and K2 in bf16, K3 on int8 codes, masked and
     unmasked, plus crafted codes that must match bitwise; K1 and K3 also at
     ``bench.py``'s retrieval batch of 128 x 96 query tokens), and time
     kernel, plain version and (for K2) ``scaled_dot_product_attention`` as
     a yardstick the port never calls, K2 and the yardstick in turns
     (kernel, library, kernel, library), with each kernel's share of its
     bound and achieved TFLOP/s (TOP/s for K3) and K2's ratio to the
     yardstick; K2's fp32 path with an fp32 head bias at Flan-T5-XL's
     encoder shape [10, 544, 32 x 64] (at scores of order 1 and of std 8)
     and with the causal mask at OPT-2.7b's [5, 544, 32 x 80], against its
     plain version and timed the same way; the names of the kernels the fp32
     yardstick runs at the cross-encoder's [50, 161, 12 x 64], read once
     from ``torch.profiler``; K2 bf16 and fp32 at the head widths beside 64
     and 80 (``K2_WIDTHS_BF16``, ``K2_WIDTHS_F32``: 8 x 16, 24 x 32, 8 x 48,
     8 x 96, 8 x 112 and 6 x 128 with the key bias; 32 and 128 with a head
     bias and under the causal mask), each against its plain version with
     its bound and SDPA's time on the same mask, and with the main path's
     launches at its shape and at its head width, looked up in the
     per-shape counts the main path's phases record; the generic kernel
     (``csrc/attention_any.cu``) at every ``K2_C9`` geometry the same way,
     each dtype required to launch its own library, each row's line beside
     the time of the FFMA kernel this one replaced (``K2_C9_EARLIER_MS``;
     not in the ``kernels`` line, which holds only this run's numbers);
  3. retrieve: full-width FLMR (BERT-base, ViT-B/32, dim 128, 32-token
     prefix, 1-layer mapping network; random bf16 weights from a seed)
     encodes 1,024 docs into a TokenIndex padded with random unit vectors to
     100,000 x 256 x 128 bf16, encodes 8 queries (32 tokens + an image) and
     serves them through RetrievalService, k = 100; the top-100 is held
     against the plain version;
  3d. raw images into the main path: 64 uint8 images, 16 at each of 480 x
     640, 640 x 480, 240 x 320 and 200 x 300, uploaded and preprocessed on
     the card by ``ops/preprocess.py::CLIPImageProcessorDevice`` (one batch
     a resolution), encoded by phase 3's FLMR and served through
     RetrievalService over phase 3's index (K2 in the query encoder, K1 in
     the search), each kernel against its plain version on the first inputs
     3d gave it at each launch shape; the pixels against the same function
     on the CPU (max |diff| <= 1e-4) and against the host path
     ``data/image_io.py`` (``tests/test_preprocess.py``'s bounds), the
     top-100 against that of the CPU-preprocessed queries up to near-ties;
     images/s on the card and on the host, each the best of 3 warm passes;
  3e. PreFLMR-L and PreFLMR-G (``configs/okvqa_flmr_{L,G}.json``'s
     ``model_config.flmr``: BERT-base, ViT-L/14 24 x 1024 or ViT-G/14 48 x
     1664 (16 heads of 64 or 104) at 224, dim 128, 32-token prefix, the
     1-layer mapping network; bf16 weights from the seed), one after the
     other: phase 3's 1,024 docs encoded into a copy of phase 3's index
     (the same padding docs), its 8 queries (320 rows each) served through
     RetrievalService, k = 100 (K2 in the BERT encoders, K1 at [8, 320,
     128] over the slabs); the top-100 against an fp32 copy of the weights
     with the kernels off up to near-ties (1% of a total), beside the bf16
     copy without them (information); PreFLMR-L's fp32 rows of one query
     against the CPU; K1 and K2 against their plain versions at 3e's launch
     shapes; query-encode and search ms, the tower's size, peak memory;
  3b. int8 retrieve: that index quantized on the card into a
     QuantizedTokenIndex and the same 8 queries served through
     RetrievalService(make_search_fn_int8), K3 over 32k-doc slabs; the
     top-100 is held against the plain int8 version;
  3c. streamed retrieve: a 262,144-doc int8 index in host RAM (the 100k
     codes of 3b, then random unit vectors quantized on the card), streamed
     slab by slab through StreamingSearcher; the values must equal those of
     the device-resident int8 search bitwise;
  4. rerank: the 8 queries x their 100 candidates x 512 tokens through
     RerankService with a full-width FullContextRerankModel in bf16; logits
     are held against a CPU fp32 recomputation of four candidates;
  4b. W8A8 rerank: the same model and weights with ``quantize_int8`` in both
     BERT configs (every BERT dense layer through ``torch._int_mm``); logits
     held against a CPU fp32 W8A8 recomputation of four candidates, and each
     dense layer's first rows against the same layer on the CPU, bitwise
     (a bf16 layer in its place would not match);
  4c. monoPreFLMR-L (``bench.py:88-118``: 3e's PreFLMR-L and a 1-layer
     cross-encoder with a 1,024-row position table) in bf16 over phase 4's
     traffic: K2 at [100, 512, 12 x 64] in the text encoder and at [100,
     800, 12 x 64] (512 text + 32 prefix + 256 patch rows) in the
     cross-encoder, 104 launches a batch; four logits against the CPU in
     fp32; K2 against its plain version at each launch shape (the first
     query's key mask), timed beside ``scaled_dot_product_attention``;
     candidates/s, the ViT-L/14 prefix's share of a batch, peak memory;
  5. monoBLIP2-Flan-T5: Blip2DecoderRerankModel at full width (ViT-g 39 x
     1408, the BERT-base Q-Former, 32 query tokens, Flan-T5-XL 24 + 24 x
     2048, 32 heads x 64) in bf16 with ``use_pallas_attention`` and
     ``position_bias_bf16``, random weights from a seed; one image and 100
     prompts of 512 tokens (544 with the prefix, a few right-padded) through
     ``make_decoder_rerank_fn``: the prefix once, the encoder in chunks of
     10 rows (K2 with the relative-position bias as its bf16 head bias), one
     decode of all 100. The relative-position tables are drawn at std 1 so
     that the head bias moves attention. p(yes) of four candidates is held
     against the same weights in fp32 on the card without the kernel, and
     the same K2 run with the encoder's head bias zeroed must miss fp32 by
     more than the tolerance; K2's head-bias variant against its plain
     version at the encoder's launch shape, at scores of order 1 and of
     std 8 (unscaled q, as T5 runs);
  5b. the same weights and prompts with ``quantize_int8`` in Flan-T5-XL
     (every projection, FFN and the head W8A8 through ``torch._int_mm``; K2
     stays bf16, 240 launches a run): each W8A8 layer's first rows against
     the same layer on the CPU, bitwise (the decoder's one-query
     cross-attention reads its K and V weights, as the JAX package does);
     p(yes) of four prompts against the same W8A8 model without K2; p(yes)
     against phase 5's bf16 as information, with candidates/s, peak memory
     and the device time by kind of kernel from ``torch.profiler``;
  6. monoBLIP2-Opt: the same vision side with OPT-2.7b (32 x 2560, 32 heads
     x 80), chunks of 5 rows (K2 with the causal mask at head_dim 80), the
     last real prompt position of each row through the 50k vocabulary; the
     same checks; 6b. OPT-2.7b W8A8, as 5b (640 K2 launches a run);
  8. FLMR training at ``bench.py:647``'s full width (BERT-base, ViT-B/32 at
     224, dim 128, 32-token prefix, 1-layer mapping network; fp32 from a
     seed, ``use_pallas_attention`` off as in the JAX package, so no kernel
     runs): one step on a 2-query sub-batch against the same step on the
     CPU in fp32 (loss, ib_loss, the gradients and updates of named
     leaves), and the card's step again with TF32 on in cuBLAS and cuDNN
     as a control that at least one of those limits must fail; 20 AdamW
     steps (lr 1e-5, mapping 1e-4, 10 warmup steps of a
     1,000-step linear schedule, vision tower frozen) on one fixed batch of
     16 queries x (1 + 1) docs of 256 tokens, whose ib_loss must fall and
     whose vision tower must stay bitwise; the NaN guard on a batch with one
     NaN pixel; a checkpoint saved and restored into a fresh model that
     takes the next step bitwise as the original; examples/s and a timer
     breakdown of the step;
  8b. the monoPreFLMR reranker's train step (phase 4's model in fp32, BCE
     over 2 queries x (1 + 2) candidates of 512 tokens, AdamW at 1e-4, its
     vision tower frozen): loss and one step's update of a cross-encoder
     leaf against the CPU, frozen leaves bitwise, steps/s; and a W8A8
     ``Int8Linear`` at BERT-base width, whose backward must be the fp32
     ``x @ w`` cotangents (straight-through);
  9. the interaction rerankers (bench.py:187-242's width and traffic: 8
     queries x 100 candidates, 128 + 512 late-interaction tokens of dim 128,
     one forward of 100 rows a query, random bf16 weights from a seed):
     9a. ModPreFLMR-BERT, the CrossEncoder type (3 BERT-base layers over
     the mapped rows, ``use_pallas_attention``): K2 at [100, 640, 12 x 64]
     in each layer, exactly 24 launches; four logits against a CPU fp32
     recomputation; K2 against its plain version at that launch shape,
     timed beside the plain version and ``scaled_dot_product_attention``;
     9b. the same traffic through the MORES type (cross-attention, then
     self-attention; no kernel on this path): no launch, four logits
     against fp32; 9c. phase 3's 8 queries (113 tokens) and their top-100
     from the index, whose token matrices and masks are gathered from the
     index after phase 3, reranked by 9a's model (K2 at L = 369, 24
     launches); 9d. one MORES training step at 9b's width in fp32
     (negative sampling over 2 queries x (1 + 2) candidates, AdamW at
     1e-4) against the same step on the CPU, then steps/s; no launch;
  10. the rest of the engine (``engine/{codec,plaid,compress,condenser,
     trainer}.py``): 10a. phase 3's 100,000 x 256 x 128 index compressed on
     the card (256 centroids, a 65,536-token sample, 2^21-token slabs, as
     ``flmr_executor.py:392-404`` does), then CompressedSearcher (k 100 of
     1,024 candidates; stage 1 through K1 over decompressed bf16 slabs) over
     ``bench.py:745``'s 32 x 96 queries and phase 3's 8 queries: compress
     seconds, queries/s (best of 3 after a warm-up), the memory ratio to the
     bf16 index, top-100 recall against the exact K1 search, the time of
     stage 1 (decompression and K1) and stage 2; the top-100 against the
     plain two-stage version on the card, stage 1 against the plain stage 1
     on one slab, and on the first 2,048 docs the card's codec against the
     CPU's; 10b. the index pooled 2x on the card and searched by K1 at
     L_d = 128 (recall against 10a's exact top-100; one batch of pooling
     against the CPU); 10c. two Baleen hops (25 then 10 passages) for 4
     questions over a synthetic 4,096-passage collection, both readers at
     ELECTRA-large width (24 x 1024, 16 heads x 64) in bf16 through K2 at
     [25, 512, 16 x 64], four passages' stage-1 scores against a CPU fp32
     recomputation, K2 against its plain version at that shape; 10d. the
     triples trainer at its config's defaults (bsize 8, nway 2, 32 + 180
     tokens) for 10 steps with a text-only FLMR at BERT-base width in fp32,
     the first step's loss and one KL-distillation step against the CPU;
     no kernel launch;
  11. the CLI (``cli.main.main``, in-process) at full width, over one
     synthetic dataset (1,500 pairs, 500 test queries, 30,000 passages,
     the visual key in the passage tail) under ``build/chip_smoke_cli/``,
     removed after: 11a. ``configs/synth_flmr_fullsize.json`` ``--mode
     train``, 20 steps, validation off, no launch; its first step's losses
     against the same step on the CPU in fp32; steps/s after 5 warm-up
     steps and peak memory; 11b. ``--mode test`` from 11a's checkpoint with
     ``use_pallas_attention`` in the text encoder: the corpus encoded
     through K2's fp32 path into the bf16 index and searched by K1; K1 and
     fp32 K2 against their plain versions on the first inputs they got at
     each launch shape (timed beside the plain version and, for K2,
     ``scaled_dot_product_attention``); the first 8 queries' top-100
     against the plain search up to near-ties; docs/s, queries/s, recall;
     11c. the same over an int8 index (K3), its top-100 overlap with 11b's;
     11d. ``configs/synth_rerank_full_context_fullsize.json`` ``--mode
     train``, 10 steps (no launch), then ``--mode test`` over 11b's dump
     with ``use_pallas_attention`` in the cross-encoder (fp32 K2): 200
     of the 500 queries x 100 candidates, none missing its static retrieval, four
     logits against the checkpoint's weights on the CPU in fp32,
     candidates/s and the reranked against the raw recall;
  12. the other reranker families and RAG from the CLI at full width, over
     phase 11's dataset, 11a's FLMR checkpoint (the frozen retriever,
     ``retriever_model_path``) and 11b's dump, each run in fp32 with
     ``use_pallas_attention`` on in every encoder at test time and off in
     training (no launch): 12a. the interaction rerankers (MORES, then the
     CrossEncoder type; ModPreFLMR-BERT's 3 BERT-base layers, dim 128), 10
     steps each, then 32 queries x 100 candidates (a cut of the 500 for
     time); 12b. the spliced reranker under PreFLMR attention fusion,
     warm-started from 11a (``reranker_backbone_path``), the same; 12c.
     monoBLIP2-Flan-T5-XL through the decoder branch (ViT-g, the Q-Former,
     Flan-T5-XL; weights drawn on the card from the seed), 5 steps of 2
     queries x 3 rows with the vision tower frozen, then 8 queries x 100
     (K2's fp32 head-bias variant in the T5 encoder); 12d.
     monoBLIP2-Opt-2.7b's head model, 8 x 100 from the seed's weights (K2's
     fp32 causal variant at head_dim 80); 12e. RAG with the BLIP-2
     Flan-T5-XL generator (3 docs a question in training, 5 in test,
     8-token answers), 3 steps, then 8 queries. Each part holds four
     candidates' scores (12e: the first query's per-doc tokens, up to
     near-ties, and losses) against the same model without the kernel on
     the card, 12a and 12b also against the checkpoint's weights on the
     CPU in fp32; fp32 K2 against its plain version at the first inputs of
     each launch shape (with the largest |head bias| where there is one);
     candidates/s (answers/s), steps/s, checkpoint seconds and sizes, peak
     memory and wall seconds of each run;
  13. real M2KR-format data and its preprocessing, from the CLI, on the
     card: 13a. an M2KR-shaped ``DatasetDict`` (``make_dummy_m2kr``'s
     columns; 2,048 train and 512 test questions, 30,000 passages in
     ``train_passages``/``test_passages``; 256 distinct images, PNGs and
     the committed baseline JPEG ``tests/fixtures/baseline_420_rst.jpg``,
     repeated across questions) written with ``data/arrow_io.py`` in the
     ``datasets`` ``save_to_disk`` layout and read back, every column
     equal; the JPEG decoded without PIL equal to its PIL pixels; 13b.
     ``cli.main --mode prepare_data`` over it: ``LoadPreprocessedData``
     (32 train and 32 test rows) -> ``CaptionImageWithBLIP2v3`` (BLIP-2
     Flan-T5-XL, 3.94 B, fp32, its HF-named checkpoint written first from
     the seed; a full-size synthetic Flan-T5 Unigram tokenizer of 32,100
     pieces with a charsmap, read by ``models/unigram.py``; the prompt
     "a photo of", so that K2's fp32 head-bias path in the T5 encoder runs
     at [8, 48, 32x64]) -> ``ExtractImageFeaturesWithViTv2`` (CLIP ViT-L/14 at 224)
     -> ``PrepareDistillationScores`` (a live FLMR teacher at BERT-base
     width, 1 positive + 4 negatives; K2's fp32 key bias at [8, 32, 768]
     and [40, 64, 768]) -> ``PrepareDataloaders``; the first caption batch
     against the plain path (greedy tokens up to near-ties; the captions
     equal the Unigram decoding of the plain path's tokens; the prompt's
     ids equal the pieces' own), the tokenizer's encodes/s and decodes/s
     on the host, the first teacher batch against it (rtol 1e-4 / atol 2e-5), the first ViT rows
     against the CPU in fp32; 13c. ``--mode train`` (10 steps) and
     ``--mode test`` over 128 of the 512 queries (K1, then K3 over an
     int8 index, both at L_d = 64)
     with ``configs/evqa_flmr.json``'s pipeline over 13a's directories at
     ``synth_flmr_fullsize.json``'s widths; 13d. M2KR as it is published:
     the committed parquet snapshot ``tests/fixtures/m2kr_snapshot``
     (README YAML configs; 1,024 + 256 + 256 questions, the train split
     in two shards, 8,192 passages) and variants (every codec, page
     version and dictionary setting), each table read by
     ``data/parquet_io.py`` to the committed SHA-256 of pyarrow's rows,
     and ``tests/fixtures/m2kr_images`` (progressive, block-smoothed,
     CMYK and YCCK JPEGs, PNGs of every bit depth, Adam7) and
     ``tests/fixtures/codec_images`` (GIF, BMP and TIFF variants) each
     decoded to the SHA-256 of PIL's pixels (``tests/fixtures/digests.json``),
     a ``datasets`` ``Image`` column in parquet to the digest of
     ``datasets``' decoding, and ``tests/fixtures/unigram_tokenizer``'s ids
     and decoded strings to the digests of the ``tokenizers`` library's;
     parquet MB/s and images/s by format (host clock, best of 3 passes);
     the snapshot's re-encoded copy ``tests/fixtures/m2kr_snapshot_v2``
     (ZSTD and LZ4_RAW, DELTA_BYTE_ARRAY and DELTA_LENGTH_BYTE_ARRAY on
     data pages v2) digesting as the SNAPPY files and loading to the same
     rows, every variant (ZSTD, LZ4, LZ4_RAW, the delta and byte-stream-
     split encodings) to its digest, parquet MB/s by codec, and the WebP
     files (``tests/fixtures/webp_images``; ``m2kr_images_webp``, each
     M2KR image as lossy, lossless or lossy-with-alpha WebP under its own
     name) to PIL's pixels, megapixels/s by WebP variant; then 13c's train
     and test runs with ``LoadM2KR`` pointed at the re-encoded copy
     (``<dir>///EVQA_data``, ``<dir>///EVQA_passages``) and the rows'
     images at the WebP re-encodings (K1, K3 and fp32 K2 over the index of
     all 8,192 passages); 13e. ``cli.main`` with ``use_pallas_attention``
     over the same data at two head geometries, 8 train steps and a test
     (32 queries) each: ``configs/evqa_flmr.json`` as published (4 heads x 16, which
     the JAX package's gate refuses: K2 launches 0 times, in training
     too) and the same block with ``configs/synth_flmr.json``'s text tower
     (4 heads x 32: the test launches fp32 K2 at head_dim 32; training
     keeps the flag off, K2 having no backward). Everything under ``build/chip_smoke_p13/``,
     removed after;
  14. the tools (``tools/``, ``ops/host_ops.py``), after phase 13, under
     ``build/chip_smoke_p14/``, removed after: 14a. a seeded BERT-base BEM
     classifier (4 token types, fp32) written as an HF directory, 64
     synthetic (question, reference, candidate) triples scored one by one
     through ``tools/eval_evqa.py::BEMScorer`` at its default 512 tokens on
     the card (K2's fp32 path at [1, 512, 768], 12 launches a triple), each
     score against the same weights on the CPU in fp32, examples/s; 14b.
     ``segmented_maxsim_host`` (the C++ host library, built with g++ on
     this machine) over the packed
     token scores of 3d's first 8 queries' top-100 docs against K1's scores
     of those docs, and ``top_k_host`` over K1's scores of every doc against
     ``torch.topk``; 14c. phase 3's FLMR (written as an HF directory in 3d)
     through ``convert_torch_to_port``, loaded into a bf16 model on the card
     by ``FLMRExecutor.load_checkpoint``, its query output on 3d's first
     batch bitwise equal to the source model's, then ``export_npz``; 14d.
     ``render_job`` for the ``--dummy`` train job of
     ``configs/okvqa_flmr.json``, run with bash (180 s limit): rc 0 and a
     ``metrics.jsonl``; 14e. a prediction dump in the executors' format from
     3d's results through ``reduce_retrieval_file`` and ``analysis``
     (``rerank_vs_list_size``, ``mcnemar_test``);
  15. several ranks (``parallel/``), after phase 14: the one-process
     references on this card, then one spawn of 4 ranks (one a card over
     NCCL where there are 4 cards, else sharing the card over gloo, whose
     times are then information only), each rank drawing its weights and
     data from the seed: 15a phase 8's FLMR step (16 x 2 x 256, fp32) at
     dp 4 and at dp 2 x tp 2, losses and four leaves' gradients and Adam
     updates against one process at phase 8's limits, the vision tower
     bitwise, a batch with a NaN pixel on one shard skipped by every rank;
     15b phase 3's 1,024-doc encode over 4 ranks (K2), the index against
     one process's; 15c a 100,000 x 256 x 128 bf16 index drawn a slab at
     a time from per-slab seeds, 25,000 docs a rank, searched in bf16 (K1)
     and int8 (K3), k = 100, ids and values against one process up to
     near-ties, each rank's K1 and K3 at the shard's launch shape against
     their plain versions on its first 2,048 docs; 15d phase 4's rerank
     (8 x 100 x 512, K2) with 25 rows of each 100-row chunk a rank, the
     logits against one process's; 15e monoBLIP2-Opt-2.7b, then
     -Flan-T5-XL, at dp 2 x tp 2 (100 prompts on 4 cards, 10 on one),
     p(yes) against one process's, K2 causal hd 80 and K2 head bias at 16
     local heads against their plain versions; 15f on 4 cards
     ``cli.main --n_devices 4`` (inside the launcher's group) over phase
     11's data: FLMR train (10 steps; the first step's losses against one
     process's), test (K1, fp32 K2; the first 8 queries' top-100 against
     one process's test of the same checkpoint), the reranker's test over
     that dump, one file of each kind written (rank 0's); on fewer cards
     the overask error. ``python3 chip_smoke.py --phase 15`` runs phases
     0, 1 and 15 alone, ``--phase 13d`` phases 0, 1, 13d and 13e;
  16. PreFLMR-G as published, after phase 15 (``p16_phase``):
     ``configs/evqa_flmr_G.json`` (BERT-base, ViT-G/14 48 x 1664 at 224,
     dim 128, a 32-token prefix, the 1-layer mapping network; the vision
     encoders frozen, the mapping group at its own lr, the clip at 1.0)
     from ``cli.main`` in fp32 over ``tests/fixtures/m2kr_snapshot`` and its
     images, only its paths, vocabulary and ``limit_train_batches`` (20)
     changed: ``--mode train`` (20 steps at batch 4, validation as the
     config has it; the first step's losses against the CPU in fp32 on the
     same weights and batch, the third step's update of every trained
     weight against AdamW's at its group's lr, every ``vision_encoder``
     weight bitwise after the run; steps/s, peak memory, the checkpoint's
     bytes and seconds, the host draw of the 1.97 B weights) and ``--mode
     test`` from the checkpoint with ``use_pallas_attention`` in the text
     encoder: 256 queries over all 8,192 passages (K1 at [4, 320, 128] x
     [8192, 64, 128], fp32 K2 in the encoders, each against its plain
     version at each launch shape), the first 8 queries' top-10 (the
     dump's) and top-100 against the plain search, the dump's metrics
     against a plain recomputation; under ``build/chip_smoke_p16/``,
     removed after. ``python3 chip_smoke.py --phase 16`` runs phases 0, 1
     and 16 alone;
  7. after phase 16: the ``kernels`` line (K1 and K3 with their times at
     ``bench.py``'s batch and the 100k searches of phases 3 and 3b beside
     the bound, K1 at stage 1's, the pooled index's, 3d's, 3e's, 11b's and 16's launch
     shapes, K3 at 11c's, K2 at each main-path variant's launch shape (3d's
     query encoder's, 3e's encoders', 4c's and 5b's and 6b's under W8A8 included),
     and K2's fp32 path at each of phase 11's, 12's, 13's and 16's launch shapes
     (K1 and K3 also at 13c's), at 14a's and at
     phase 2's head-bias and causal shapes, each with the bound of 3xTF32 products and the
     bound of fp32 FFMA beside it), then the result line.

``python3 chip_smoke.py --probe-t5-init`` instead builds the kernels and
runs phase 5's model once with every weight at std 0.02 (none of HF T5's
scales): p(yes) of four candidates through K2 and through the plain path in
bf16, and in fp32, as information.

The launch counters are set to 0 just before each main-path phase (3, 3d,
3e for each scale, 3b, 3c, 4, 4b, 4c, 5, 5b, 6, 6b, 8's training run, 9a,
9b, 9c, 9d's timed steps, 10a, 10b, 10c, 10d, each CLI run of 11, 12 and
13 and 16, 14a, and each of 15a-15f in every rank, whose counts the parent
sums) and read just after it; phases 8, 15a, 9b, 9d, 10d, 11a, 11d's, every
phase-12 training run and 13c's must launch none, 16's training run only
its validation's K1. Phase 3's index stays on
the card until phase 10b. Each of 3e's models, 4c's and each decoder family
is built, run and freed before the next (about 8 GB a decoder family in
bf16; 5b and 6b share 5's and 6's tensors).
Any failed check raises and the script exits non-zero; without a CUDA card
it exits non-zero before printing anything.
"""

import dataclasses
import gc
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
# H100 SXM data-sheet peaks (dense): bf16 and int8 tensor cores, HBM3
# bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12
# K1: fp32 dot products of unit vectors, fp32 sums of <= 113 maxima in a
# different order than the plain version's matmul
K1_TOL = 2e-3
# phase 2: bench.py's retrieval query batch (bench.py:560, 610)
BENCH_QUERIES, BENCH_LQ = 128, 96
# phase 3c: a host index of 262,144 docs (16 slabs of 16,384)
STREAM_DOCS, STREAM_SLAB = 262_144, 16_384
# K3: the int32 maxima are exact on both sides; only the order of the fp32
# sums of at most 113 scaled maxima (totals below ~40) differs
K3_TOL = 2e-3
# K2: bf16 outputs of order 1; the kernel rounds unnormalised probabilities
# to bf16 where the plain version rounds normalised ones, and sums in
# another order: a few bf16 spacings
K2_TOL = 3e-2
# K2 at scores of std 8 (T5's unscaled q): near-argmax rows output about one
# row of v, up to |v| ~ 5, where one bf16 spacing is 2^-5 > K2_TOL; K2_TOL
# plus half a bf16 spacing of the output
K2_RTOL_BIG = 2 ** -8
# rerank logits in bf16 on the card against fp32 on the CPU through 12 + 1 +
# 1 BERT layers and the ViT: bf16 keeps 8 mantissa bits, about 0.4% per
# rounding, which the residual stream accumulates to a few percent
RERANK_ATOL, RERANK_RTOL = 0.05, 0.05
# phase 4b: rows of each dense layer's first input recomputed on the CPU
W8A8_LAYER_ROWS = 64
# phases 5 and 6: 100 prompts of 512 tokens for one image; p(yes) of the
# first DECODER_CHECK candidates recomputed in fp32 on the card
DECODER_K, DECODER_L, DECODER_CHECK = 100, 512, 4
# p(yes) in bf16 through ViT-g (39 layers), the Q-Former (12) and Flan-T5-XL
# (24 + 24) or OPT-2.7b (32) against fp32 on the same weights: bf16 keeps 8
# mantissa bits (0.4% a rounding), which ~100 residual layers accumulate to a
# few percent of the final hidden state, a few hundredths of the yes-no logit
# gap; p(yes) moves at most a quarter of that
P_YES_TOL = 0.05
# phase 5 draws T5's relative-position tables at std 1, not HF's d_model^-1/2
# (0.022): at HF's scales the attention scores are of order 1, so a 0.022
# head bias would hardly move attention and the p(yes) check could not see
# K2's head-bias path; at std 1 the bias moves attention as much as q.k
REL_BIAS_STD = 1.0
ENC_REL_BIAS = "model.language_model.encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"
T5_YES_NO, OPT_YES_NO = (4273, 150), (4763, 117)
# phase 8: bench.py:654-688's training batch; the first TRAIN_SUB queries
# (with their docs) are recomputed on the CPU
TRAIN_B, TRAIN_NWAY, TRAIN_LQ, TRAIN_LD, TRAIN_STEPS, TRAIN_WARMUP, TRAIN_SUB = (
    16, 2, 32, 256, 20, 5, 2)
# losses, card against CPU, both fp32 (TF32 off for cuBLAS and cuDNN), as a
# share of max(1, |loss|); and each named leaf's gradient off the CPU's, as
# a share of the leaf's largest |g|. Round-off alone: each product sums up
# to 3,072 terms in another order, sqrt(3072) * 2^-24 = 3e-6 relative, which
# the backward carries through 25 layers. The same step with TF32 on (10
# mantissa bits, 2^-11 = 5e-4 a product) runs as a control in phase 8, and
# at least one limit must fail it. On an H100 80GB HBM3 at 700 W the fp32
# losses read equal to the last bit (the reranker's 1.2e-7 apart) and the
# gradients 2.6e-6 to 5.8e-6 apart; with TF32, the losses 8.2e-4 to 1.2e-3
# and the gradients 2.1e-2 to 0.23 apart. The loss limit lies about eighty
# times from either; the gradient limit nine times above fp32's and four
# hundred times below TF32's.
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 5e-5
ADAM_EPS = 1e-8
# phase 8b: the reranker's training batch (configs/evqa_rerank_full_context.json:135,153)
RERANK_TRAIN_B, RERANK_TRAIN_NWAY = 2, 3
# the W8A8 backward against x @ w's fp32 cotangents: the same fp32 products
# (TF32 off), summed by cuBLAS in the same order up to its choice of kernel
INT8_GRAD_TOL = 1e-5
CKPT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_checkpoints"
# phase 9: bench.py:187-242's interaction traffic: 8 queries x 100 candidates,
# 128 query and 512 doc tokens of dim 128, one forward of 100 rows a query
INTER_B, INTER_K, INTER_LQ, INTER_LD, INTER_DIM, INTER_LAYERS = 8, 100, 128, 512, 128, 3
# interaction logits in bf16 on the card against fp32 on the CPU through the
# mapping and 3 BERT layers: bf16 keeps 8 mantissa bits (0.4% a rounding),
# which 3 residual layers carry into about 1% of the CLS row; the logits
# (std ~0.5 at these random weights) move by about 0.005-0.01
INTER_ATOL, INTER_RTOL = 0.05, 0.05
# phase 9d: configs/evqa_rerank_interaction.json's training (negative sampling,
# num_negative_samples 2, AdamW at 1e-4), 2 queries
MORES_TRAIN_B, MORES_TRAIN_NWAY = 2, 3
# its steps/s: the median of 4 windows of 5 steps each, after 3 warm-up steps
MORES_WARMUP, MORES_WINDOWS, MORES_WINDOW_STEPS = 3, 4, 5
# phase 10a: bench.py:723-800's compressed retrieval at BENCH_PLAID_N=100000
# (phase 3's index): 32 queries x 96 tokens drawn as bench.py:745 draws them,
# k = 100 of 1,024 candidates, the executor's codec settings
# (flmr_executor.py:392-404: 256 centroids; the codec's 65,536-token sample
# and 2^21-token slabs)
PLAID_B, PLAID_LQ, PLAID_K, PLAID_CANDIDATES, PLAID_CENTROIDS = 32, 96, 100, 1024, 256
# the card's compress against the CPU's on the index's first docs
PLAID_SUBSET = 2048
# stage 1 through K1 against the plain stage 1, and the card's final top-100
# against the plain two-stage version: exact bf16 products in fp32 on both
# sides, summed in another order; queries of norm ~11 give totals up to ~100
PLAID_ATOL, PLAID_RTOL = 2e-3, 2e-5
# the codec, card against CPU: centroids are fp32 sums of up to a few
# thousand unit rows in another order (1e-5); a token's code may differ only
# where the CPU's scores of the two centroids lie within CODE_TIE; a residual
# only where the two unrounded residual / scale values straddle a rounding
# boundary less than RESID_TIE of a step apart
CENTROID_TOL, CODE_TIE, RESID_TIE = 1e-5, 1e-5, 0.05
# phase 10b: pooling factor 2, BATCH docs a call; one batch of
# POOL_CHECK_DOCS docs against the CPU within one bf16 spacing of a unit
# vector
POOL_FACTOR, POOL_BATCH, POOL_CHECK_DOCS = 2, 8192, 256
# phase 10c: Baleen's reader at ELECTRA-large width (the public config of
# google/electra-large-discriminator), 4,096 passages, 4 questions, two hops
BALEEN_PASSAGES, BALEEN_QUERIES, BALEEN_MAXLEN, BALEEN_QTOKENS = 4096, 4, 512, 32
# sentence scores in bf16 on the card against fp32 on the CPU through 24
# layers: bf16 keeps 8 mantissa bits (0.4% a rounding), which 24 residual
# layers accumulate to a few percent of the final hidden state; the head's
# scores (std ~0.6 at these random weights) move by a few hundredths
BALEEN_ATOL, BALEEN_RTOL = 0.1, 0.05
# phase 10d: the triples trainer at its config's defaults, 10 steps (CE), and
# one KL-distillation step over 2 queries, both against the CPU
TRIPLES_STEPS, TRIPLES_KL_B = 10, 2


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps, warmup=1):
    """Mean ms of ``fn`` over ``reps`` launches, timed with CUDA events after
    ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k2_timed(kernel, library, flops, bound_ms, reps=10):
    """K2 and its library yardstick timed in turns (kernel, library, kernel,
    library) on the same inputs; ms and library_ms are the means of the two
    turns. Adds the ratio to the library, the share of the bound and the
    achieved TFLOP/s."""
    turns = [cuda_ms(fn, reps) for fn in (kernel, library, kernel, library)]
    ms, lib_ms = (turns[0] + turns[2]) / 2, (turns[1] + turns[3]) / 2
    return dict(ms=ms, library_ms=lib_ms, ms_turns=turns[0::2], library_ms_turns=turns[1::2],
                x_library=ms / lib_ms, share_of_bound=bound_ms / ms,
                tflops=flops / (ms * 1e-3) / 1e12)


def ptxas_report(name):
    """Registers, static shared memory and spill bytes of each kernel of the
    library ``name``, parsed from the ``-Xptxas -v`` log its build wrote."""
    import re

    from reranking_multimodal_retrievers_tpu_torch.ops import _build

    text = _build._target(name).with_suffix(".log").read_text(errors="replace")
    entries = []
    for block in text.split("Compiling entry function")[1:]:
        ent = re.match(r" '([^']+)'", block).group(1)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        entries.append(dict(entry=ent, registers=int(regs.group(1)),
                            static_smem_bytes=int(smem.group(1)) if smem else 0,
                            spill_bytes=int(spill.group(1)) + int(spill.group(2))))
    return dict(kernels=len(entries), max_registers=max(e["registers"] for e in entries),
                spill_bytes=sum(e["spill_bytes"] for e in entries), entries=entries)


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def unit(gen, *shape):
    x = torch.randn(*shape, device=gen.device, generator=gen)
    return (x / x.norm(dim=-1, keepdim=True)).to(torch.bfloat16)


def _counters():
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention, fused_self_attention_any, fused_self_attention_f32)
    from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_cuda import maxsim_scores
    from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_int8_cuda import maxsim_scores_int8

    return {"K1": maxsim_scores, "K2": fused_self_attention, "K3": maxsim_scores_int8,
            "K2f32": fused_self_attention_f32, "K2any": fused_self_attention_any}


def reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def check_k1(Q, D, M, plain_reps=3):
    """K1 against its plain version on unit vectors with the mask ``M``
    (which has whole-padding docs), timed beside it. Returns K1's line."""
    from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_cuda import (
        maxsim_scores, maxsim_scores_reference)

    B, LQ, DIM = Q.shape
    N, LD, _ = D.shape
    got = maxsim_scores(Q, D, M)
    ref = maxsim_scores_reference(Q, D, M)
    valid = M.any(dim=1)
    err = (got - ref)[:, valid].abs().max().item()
    pad_rel = ((got - ref)[:, ~valid].abs() / ref[:, ~valid].abs()).max().item()
    check(err <= K1_TOL, f"K1 at {[B, LQ]}: max |diff| {err} > {K1_TOL}")
    check(pad_rel <= 1e-5 and ref[:, ~valid].max().item() < -9000 * LQ,
          f"K1 whole-padding doc at {[B, LQ]}: relative diff {pad_rel}")
    del got, ref
    flops = 2 * B * LQ * N * LD * DIM
    b_ms, b_by = bound(flops, Q.numel() * 2 + D.numel() * 2 + M.numel() + B * N * 4)
    ms = cuda_ms(lambda: maxsim_scores(Q, D, M), 20)
    return dict(shape=[[B, LQ, DIM], [N, LD, DIM]], max_abs_err=err, tol=K1_TOL, ms=ms,
                plain_ms=cuda_ms(lambda: maxsim_scores_reference(Q, D, M), plain_reps),
                bound_ms=b_ms, bound_by=b_by, library_ms=None, share_of_bound=b_ms / ms,
                tflops=flops / (ms * 1e-3) / 1e12)


def check_k3(Q, D, M, crafted=True, plain_reps=3):
    """K3 against its plain version on the codes of the K1 check's unit
    vectors, quantized as the int8 index and queries are (with the mask and
    without), and (``crafted``) on crafted codes with unit scales, whose
    totals are integers below 2^24 and must match bitwise. Returns K3's
    line."""
    from reranking_multimodal_retrievers_tpu_torch.engine.index import quantize_docs
    from reranking_multimodal_retrievers_tpu_torch.engine.search import quantize_queries
    from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_int8_cuda import (
        maxsim_scores_int8, maxsim_scores_int8_reference)

    B, LQ, DIM = Q.shape
    N, LD, _ = D.shape
    Qq, qs = quantize_queries(Q.float())
    Dq, ds = quantize_docs(D, M)
    valid = M.any(dim=1)
    errs = {}
    for name, m in (("masked", M), ("unmasked", None)):
        got = maxsim_scores_int8(Qq, qs, Dq, ds, m)
        ref = maxsim_scores_int8_reference(Qq, qs, Dq, ds, m)
        real = valid if m is not None else torch.ones_like(valid)
        errs[name] = (got - ref)[:, real].abs().max().item()
        check(errs[name] <= K3_TOL, f"K3 {name}: max |diff| {errs[name]} > {K3_TOL}")
        if m is not None:  # whole-padding docs total about -2^25 * sum(qs) * ds
            pad_rel = ((got - ref)[:, ~valid].abs() / ref[:, ~valid].abs()).max().item()
            check(pad_rel <= 1e-5 and ref[:, ~valid].max().item() < 0,
                  f"K3 whole-padding docs: relative diff {pad_rel}")
    line = dict(shape=[[B, LQ, DIM], [N, LD, DIM]], max_abs_err=max(errs.values()),
                max_abs_err_unmasked=errs["unmasked"], tol=K3_TOL)
    if crafted:
        gen = torch.Generator(device=Q.device).manual_seed(SEED + 1)
        Cq = torch.randint(-8, 9, (B, LQ, DIM), dtype=torch.int8, device=Q.device, generator=gen)
        Cd = torch.randint(-8, 9, (N, LD, DIM), dtype=torch.int8, device=Q.device, generator=gen)
        lens = torch.randint(1, LD + 1, (N,), device=Q.device, generator=gen)
        Cm = torch.arange(LD, device=Q.device)[None, :] < lens[:, None]
        ones_q, ones_d = torch.ones(B, LQ, device=Q.device), torch.ones(N, device=Q.device)
        line["crafted_bitwise"] = torch.equal(
            maxsim_scores_int8(Cq, ones_q, Cd, ones_d, Cm),
            maxsim_scores_int8_reference(Cq, ones_q, Cd, ones_d, Cm))
        check(line["crafted_bitwise"], "K3 on crafted codes: not bitwise equal to the plain version")
    ops = 2 * B * LQ * N * LD * DIM
    b_ms, b_by = bound(ops, Qq.numel() + qs.numel() * 4 + Dq.numel() + ds.numel() * 4 + M.numel()
                       + B * N * 4, PEAK_INT8_OPS)
    ms = cuda_ms(lambda: maxsim_scores_int8(Qq, qs, Dq, ds, M), 20)
    return dict(line, ms=ms,
                plain_ms=cuda_ms(lambda: maxsim_scores_int8_reference(Qq, qs, Dq, ds, M),
                                 plain_reps),
                bound_ms=b_ms, bound_by=b_by, library_ms=None, share_of_bound=b_ms / ms,
                tops=ops / (ms * 1e-3) / 1e12)


def int8_retrieve(index, Qm, k, bf16_ids):
    """Phase 3b: quantize ``index`` on its device and serve the query
    matrices ``Qm`` through RetrievalService over the int8 program; hold the
    top-k against the plain int8 version. Returns (QuantizedTokenIndex, the
    phase's line)."""
    from reranking_multimodal_retrievers_tpu_torch.engine import (
        QuantizedTokenIndex, make_search_fn_int8)
    from reranking_multimodal_retrievers_tpu_torch.engine.index import quantize_docs
    from reranking_multimodal_retrievers_tpu_torch.engine.search import quantize_queries
    from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_int8_cuda import (
        maxsim_scores_int8_reference)
    from reranking_multimodal_retrievers_tpu_torch.serving import RetrievalService

    t0 = time.perf_counter()
    BQ, LQ, _ = Qm.shape
    reset_counts()
    qindex = QuantizedTokenIndex.from_token_index(index)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    N, LD, DIM = qindex.codes.shape
    # the codes and scales made on the card are the CPU quantizer's, bitwise
    # (the CPU tests hold that one bitwise to the JAX package's)
    n_cpu = min(N, 2048)
    cpu_codes, cpu_scales = quantize_docs(index.embeddings[:n_cpu].cpu(), index.mask[:n_cpu].cpu())
    check(torch.equal(cpu_codes, qindex.codes[:n_cpu].cpu())
          and torch.equal(cpu_scales, qindex.scales[:n_cpu].cpu()),
          "int8 codes or scales made on the card differ from the CPU's")
    svc = RetrievalService(make_search_fn_int8(N, k=k), qindex, batch_queries=BQ, max_wait_ms=50)
    try:
        t1 = time.perf_counter()
        results = [f.result(timeout=600) for f in [svc.search(Qm[i]) for i in range(BQ)]]
        search_s = time.perf_counter() - t1
    finally:
        svc.close()
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches["K3"] > 0 and launches["K1"] == 0, f"int8 retrieve launches {launches}")

    # the search program alone, after the counts were read
    Qf = Qm.float()
    search_ms = cuda_ms(lambda: make_search_fn_int8(N, k=k)(Qf, *qindex.search_arrays), 3)
    b_ms, b_by = bound(2 * BQ * LQ * N * LD * DIM,
                       Qf.numel() * 4 + qindex.codes.numel() + N * 4 + qindex.mask.numel()
                       + BQ * N * 4, PEAK_INT8_OPS)
    ref = maxsim_scores_int8_reference(*quantize_queries(Qf), qindex.codes, qindex.scales,
                                       qindex.mask)
    ref_vals, ref_idx = torch.topk(ref, k, dim=1)
    identical, worst, overlap = 0, 0.0, []
    for i, (ids, vals) in enumerate(results):
        got_idx = torch.as_tensor([int(x) for x in ids], device=ref.device)
        check(len(ids) == k and bool(np.isfinite(vals).all()), f"int8 query {i}: {len(ids)} results")
        identical += int(torch.equal(got_idx, ref_idx[i]))
        # ranks may differ only between docs whose plain scores lie within
        # the K3 tolerance; the served values match the plain scores
        swap = (ref[i, got_idx] - ref_vals[i]).abs().max().item()
        served = (torch.as_tensor(vals, device=ref.device) - ref[i, got_idx]).abs().max().item()
        worst = max(worst, swap, served)
        overlap.append(len({int(x) for x in ids} & set(bf16_ids[i])) / k)
    check(worst <= K3_TOL, f"int8 retrieval top-{k} off the plain version by {worst}")
    return qindex, {
        "phase": "retrieve_int8", "index": [N, LD, DIM], "index_bytes": qindex.codes.numel()
        + N * 4 + qindex.mask.numel(), "queries": BQ, "k": k, "quantize_seconds": quantize_s,
        "codes_bitwise_vs_cpu_docs": n_cpu,
        "search_seconds": search_s, "search_ms": search_ms, "search_bound_ms": b_ms,
        "search_bound_by": b_by, "identical_rankings": identical, "max_abs_err": worst,
        "overlap_with_bf16_topk": {"min": min(overlap), "mean": float(np.mean(overlap))},
        "launches": launches, "seconds": time.perf_counter() - t0}


def host_docs_that_fit(per_doc_bytes, want, slab):
    """The largest multiple of ``slab`` docs, at most ``want``, whose host
    index fits in half of ``MemAvailable``; and ``MemAvailable`` in bytes."""
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f
                     if line.startswith("MemAvailable:"))
    return min(want, avail // 2 // per_doc_bytes // slab * slab), avail


def streamed_retrieve(qindex, Qm, k, gen, n_want=STREAM_DOCS, slab=STREAM_SLAB):
    """Phase 3c: a host-RAM int8 index of ``n_want`` docs (the codes of
    ``qindex``, then random unit vectors quantized on the device) streamed
    through StreamingSearcher, twice; the values must equal the
    device-resident int8 search's bitwise. Returns the phase's line."""
    from reranking_multimodal_retrievers_tpu_torch.engine import (
        HostQuantizedTokenIndex, StreamingSearcher, make_search_fn_int8)
    from reranking_multimodal_retrievers_tpu_torch.engine.index import quantize_docs
    from reranking_multimodal_retrievers_tpu_torch.engine.search import quantize_queries
    from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_int8_cuda import maxsim_scores_int8

    t0 = time.perf_counter()
    n_res, LD, DIM = qindex.codes.shape
    n_host, avail = host_docs_that_fit(LD * DIM + 4 + LD, n_want, slab)
    check(n_host >= slab, f"host RAM holds {n_host} docs, less than one slab")
    dev = qindex.codes.device
    codes = torch.empty(n_host, LD, DIM, dtype=torch.int8, device=dev)
    scales = torch.empty(n_host, dtype=torch.float32, device=dev)
    mask = torch.ones(n_host, LD, dtype=torch.bool, device=dev)
    n_q = min(n_host, n_res)
    codes[:n_q], scales[:n_q], mask[:n_q] = (qindex.codes[:n_q], qindex.scales[:n_q],
                                             qindex.mask[:n_q])
    for s in range(n_q, n_host, slab):
        e = min(n_host, s + slab)
        codes[s:e], scales[s:e] = quantize_docs(unit(gen, e - s, LD, DIM), mask[s:e])
    host = HostQuantizedTokenIndex(codes=np.empty((n_host, LD, DIM), np.int8),
                                   scales=np.empty(n_host, np.float32),
                                   mask=np.empty((n_host, LD), bool))
    for s in range(0, n_host, slab):
        for h, d in ((host.codes, codes), (host.scales, scales), (host.mask, mask)):
            torch.from_numpy(h[s:s + slab]).copy_(d[s:s + slab])
    build_s = time.perf_counter() - t0

    Qf = Qm.float()
    searcher = StreamingSearcher(host, k=k, slab_docs=slab, device=dev)
    n_slabs = -(-n_host // slab)
    reset_counts()
    pass_s, fill_s = [], []
    for _ in range(2):  # the first pass also allocates the pinned staging buffers
        t1 = time.perf_counter()
        vals, idx = searcher.search(Qf)
        pass_s.append(time.perf_counter() - t1)
        fill_s.append(searcher.last_fill_seconds)
    launches = read_counts()
    check(launches["K3"] == 2 * n_slabs, f"streamed launches {launches}, {n_slabs} slabs")

    res_v, res_i = make_search_fn_int8(n_host, k=k)(Qf, codes, scales, mask)
    res_v, res_i = res_v.cpu().numpy(), res_i.cpu().numpy()
    check(np.array_equal(vals, res_v), "streamed values differ from the resident search: "
          f"max |diff| {np.abs(vals - res_v).max()}")
    moved = list(zip(*np.nonzero(idx != res_i)))
    check(all((vals[b] == vals[b, p]).sum() > 1 for b, p in moved),
          "streamed ids differ from the resident search outside exact ties")
    Qq, qs = quantize_queries(Qf)
    k3_s = cuda_ms(lambda: [maxsim_scores_int8(Qq, qs, codes[s:s + slab], scales[s:s + slab],
                                               mask[s:s + slab])
                            for s in range(0, n_host, slab)], 2) / 1e3
    host_bytes = host.codes.nbytes + host.scales.nbytes + host.mask.nbytes
    return {"phase": "retrieve_streamed", "host_docs": n_host, "host_docs_wanted": n_want,
            "mem_available_bytes": avail, "host_index_bytes": host_bytes, "slab_docs": slab,
            "slabs": n_slabs, "queries": Qm.shape[0], "k": k, "build_seconds": build_s,
            "pass_seconds": pass_s, "host_fill_seconds": fill_s,
            "host_to_device_gb_per_s": host_bytes / pass_s[-1] / 1e9,
            "k3_seconds_alone": k3_s, "values_bitwise_equal": True,
            "ids_differing_within_ties": len(moved), "launches": launches,
            "seconds": time.perf_counter() - t0}


def keep_first_rows(seen, name):
    """A forward hook that keeps, in ``seen[name]``, the first
    ``W8A8_LAYER_ROWS`` rows of a layer's first input and output."""
    def hook(module, args, out):
        if name not in seen:
            x = args[0]
            seen[name] = (x.reshape(-1, x.shape[-1])[:W8A8_LAYER_ROWS].clone(),
                          out.reshape(-1, out.shape[-1])[:W8A8_LAYER_ROWS].clone())
    return hook


def check_int8_layers(layers, seen):
    """Every ``Int8Linear`` of the served model ran W8A8 on the card: its
    output on the kept rows is bitwise that of the same layer on the CPU
    (``_int_mm`` is exact there and the quantizers are the CPU's), where a
    bf16 ``nn.Linear`` in its place gives another result. Returns the number
    of layers checked and the smallest max |bf16 - W8A8| over them."""
    from reranking_multimodal_retrievers_tpu_torch.ops.quant import Int8Linear

    check(layers and set(seen) == set(layers),
          f"W8A8 layers run: {len(seen)} of {len(layers)}")
    gaps = []
    with torch.inference_mode():
        for name, (x, y) in seen.items():
            mod = layers[name]
            cpu = Int8Linear(mod.in_features, mod.out_features, bias=mod.bias is not None,
                             device="meta")
            cpu.load_state_dict({k: v.cpu() for k, v in mod.state_dict().items()}, assign=True)
            check(torch.equal(y.cpu(), cpu(x.cpu())), f"{name}: W8A8 on the card != CPU")
            bf16 = torch.nn.functional.linear(x, mod.weight, mod.bias)
            check(not torch.equal(bf16, y), f"{name}: bf16 gives the W8A8 result")
            gaps.append(float((bf16.float() - y.float()).abs().max()))
    return len(seen), min(gaps)


def w8a8_rerank(reranker, rcfg, ids, am, tt, pix, bf16_logits, cpu_state):
    """Phase 4b: the rerank model ``reranker`` with ``quantize_int8`` in both
    BERT configs and the same weights, through RerankService; logits held
    against a CPU fp32 W8A8 recomputation of four candidates (``cpu_state``:
    the weights in fp32 on the CPU), and every dense layer's first rows of
    the first batch against the same layer on the CPU, bitwise
    (``check_int8_layers``). Returns the phase's line."""
    from reranking_multimodal_retrievers_tpu_torch.engine import make_chunked_rerank_fn
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import (
        FullContextRerankModel)
    from reranking_multimodal_retrievers_tpu_torch.ops.quant import Int8Linear
    from reranking_multimodal_retrievers_tpu_torch.serving import RerankService

    t0 = time.perf_counter()
    q8 = lambda cfg: dataclasses.replace(cfg, quantize_int8=True)  # noqa: E731
    rcfg8 = dataclasses.replace(
        rcfg, flmr=dataclasses.replace(rcfg.flmr, text_config=q8(rcfg.flmr.text_config)),
        cross_encoder=q8(rcfg.cross_encoder))
    model = FullContextRerankModel(rcfg8, device="meta")  # the bf16 model's weights
    model.load_state_dict(reranker.state_dict(), assign=True)
    model.eval()
    BQ, K, L = ids.shape
    dev = next(reranker.parameters()).device
    rsvc = RerankService(make_chunked_rerank_fn(model, nway=K, chunk_size=100), nway=K,
                         max_batch=BQ, max_wait_ms=50, device=dev)
    layers = {name: m for name, m in model.named_modules() if isinstance(m, Int8Linear)}
    seen = {}
    hooks = [m.register_forward_hook(keep_first_rows(seen, name)) for name, m in layers.items()]
    reset_counts()
    try:
        batch_s = []
        for _ in range(2):
            t1 = time.perf_counter()
            futs = [rsvc.rerank(ids[i], am[i], tt, pix[i]) for i in range(BQ)]
            logits = np.stack([f.result(timeout=600) for f in futs])
            batch_s.append(time.perf_counter() - t1)
            for h in hooks:  # the first batch, which warms up, feeds the layer check
                h.remove()
    finally:
        for h in hooks:
            h.remove()
        rsvc.close()
    torch.cuda.synchronize()
    launches = read_counts()
    check(logits.shape == (BQ, K) and bool(np.isfinite(logits).all()), f"logits {logits.shape}")
    check(launches["K2"] > 0, f"W8A8 rerank launches {launches}")

    t1 = time.perf_counter()
    layers_checked, layer_gap = check_int8_layers(layers, seen)
    cpu_model = FullContextRerankModel(rcfg8, device="meta")
    cpu_model.load_state_dict(cpu_state, assign=True)
    want = make_chunked_rerank_fn(cpu_model, nway=4, chunk_size=4)(
        torch.as_tensor(ids[0, :4]), torch.as_tensor(am[0, :4]), torch.as_tensor(tt[:4]),
        pix[:1].float())[0].numpy()
    err = float(np.abs(logits[0, :4] - want).max())
    check(np.allclose(logits[0, :4], want, atol=RERANK_ATOL, rtol=RERANK_RTOL),
          f"W8A8 rerank logits {logits[0, :4]} vs CPU fp32 W8A8 {want}")
    # information: phase 4's bf16 logits of the same candidates against the
    # W8A8 recomputation (at this tolerance the logits alone cannot tell
    # the two apart; the layer check above does)
    bf16_gap = float(np.abs(bf16_logits[0, :4] - want).max())

    def ranks(x):
        return np.argsort(np.argsort(x))

    rho = [float(np.corrcoef(ranks(a), ranks(b))[0, 1]) for a, b in zip(logits, bf16_logits)]
    top1 = int(sum(np.argmax(a) == np.argmax(b) for a, b in zip(logits, bf16_logits)))
    return {"phase": "rerank_w8a8", "queries": BQ, "candidates": K, "seq_len": L,
            "batch_seconds": batch_s, "candidates_per_s": BQ * K / batch_s[-1],
            "max_abs_err_vs_cpu_fp32_w8a8": err, "max_abs_gap_bf16_vs_cpu_fp32_w8a8": bf16_gap,
            "int8_layers_bitwise": layers_checked, "min_layer_gap_bf16": layer_gap,
            "logit_std": float(logits.std()),
            "spearman_vs_bf16": rho, "top1_agreement_vs_bf16": top1,
            "cpu_check_seconds": time.perf_counter() - t1, "launches": launches,
            "seconds": time.perf_counter() - t0}


def _k2_dtype(q):
    return {torch.bfloat16: "bf16", torch.float32: "fp32"}[q.dtype]


def _k2_mask(bias, head_bias, causal):
    """Which of K2's options a call takes: "causal", "head" (a head bias),
    "key" (a key bias alone) or "none"."""
    return ("causal" if causal else "head" if head_bias is not None
            else "key" if bias is not None else "none")


def k2_variant(name, q, k, v, bias, head_bias, *, heads, scale, causal, sdpa_mask, flops):
    """One K2 variant against its plain version on the card at a phase's
    launch shape, timed beside the plain version and
    ``scaled_dot_product_attention`` with ``sdpa_mask`` (a yardstick the
    port never calls). Returns the variant's line."""
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention, fused_self_attention_reference)

    kw = dict(num_heads=heads, sm_scale=scale, causal=causal)
    got = fused_self_attention(q, k, v, bias, head_bias, **kw)
    ref = fused_self_attention_reference(q, k, v, bias, head_bias, **kw)
    err = (got.float() - ref.float()).abs().max().item()
    check(bool(torch.isfinite(got).all()) and err <= K2_TOL,
          f"K2 {name}: max |diff| {err} > {K2_TOL}")
    B, L, HD = q.shape
    qh, kh, vh = (x.view(B, L, heads, HD // heads).transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    nbytes = 4 * q.numel() * 2 + bias.numel() * 4
    if head_bias is not None:
        nbytes += head_bias.numel() * head_bias.element_size()
    b_ms, b_by = bound(flops, nbytes)
    times = k2_timed(lambda: fused_self_attention(q, k, v, bias, head_bias, **kw),
                     lambda: sdpa(qh, kh, vh, attn_mask=sdpa_mask, scale=scale), flops, b_ms)
    return dict(variant=name, shape=[B, L, HD], heads=heads, dtype=_k2_dtype(q),
                mask=_k2_mask(bias, head_bias, causal), max_abs_err=err, tol=K2_TOL,
                plain_ms=cuda_ms(lambda: fused_self_attention_reference(q, k, v, bias,
                                                                        head_bias, **kw), 3),
                bound_ms=b_ms, bound_by=b_by, flops=flops, **times)


def _decoder_config(text_config, yes_no):
    from reranking_multimodal_retrievers_tpu_torch.models import (
        Blip2Config, Blip2QFormerConfig, Blip2VisionConfig)
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import Blip2RerankConfig

    return Blip2RerankConfig(
        blip2=Blip2Config(vision_config=Blip2VisionConfig(), qformer_config=Blip2QFormerConfig(),
                          text_config=text_config, num_query_tokens=32),
        yes_token_id=yes_no[0], no_token_id=yes_no[1])


def _decoder_inputs(is_opt, vocab_hi):
    """DECODER_K prompts of DECODER_L tokens from the seed, a few of them
    right-padded, and one image: (ids, mask, padded rows, pixels)."""
    rng = np.random.default_rng(SEED)
    K, L = DECODER_K, DECODER_L
    ids = torch.as_tensor(rng.integers(10, vocab_hi, size=(K, L))).cuda()
    am = torch.ones(K, L, dtype=torch.long, device="cuda")
    padded = list(range(3, K, 7))  # right-padded prompts, the 4th of them among the checked
    for r in padded:
        n = int(rng.integers(L // 2, L))
        am[r, n:] = 0
        ids[r, n:] = 1 if is_opt else 0
    pix = torch.as_tensor(rng.normal(size=(1, 3, 224, 224)).astype(np.float32)).cuda()
    return ids, am, padded, pix


def _plain_p_yes(model, ids, am, pix):
    """p(yes) of ``ids`` on ``model``'s weights without the kernel: in bf16,
    sharing the tensors, and in fp32."""
    from reranking_multimodal_retrievers_tpu_torch.engine import make_decoder_rerank_fn
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import Blip2DecoderRerankModel

    cfg = model.config
    tc = dataclasses.replace(cfg.blip2.text_config, use_pallas_attention=False)
    cfg = dataclasses.replace(cfg, blip2=dataclasses.replace(cfg.blip2, text_config=tc))
    plain = Blip2DecoderRerankModel(cfg, device="meta")
    plain.load_state_dict(model.state_dict(), assign=True)
    n = ids.shape[0]
    p_bf16 = make_decoder_rerank_fn(plain.eval(), chunk_size=n)(ids, am, pix.to(torch.bfloat16))
    plain.load_state_dict({k: t.float() for k, t in model.state_dict().items()}, assign=True)
    return p_bf16, make_decoder_rerank_fn(plain, chunk_size=n)(ids, am, pix)


def t5_init_probe(smi):
    """``python3 chip_smoke.py --probe-t5-init``, not part of the main run:
    phase 5's model with every weight at std 0.02 (none of HF T5's scales,
    so T5's unscaled attention scores have std ~6.5). p(yes) of
    DECODER_CHECK candidates through K2 in bf16, through the plain path in
    bf16 and through the plain path in fp32, as information: how far bf16
    alone, with and without the kernel, lands from fp32 at that init."""
    from reranking_multimodal_retrievers_tpu_torch.engine import make_decoder_rerank_fn
    from reranking_multimodal_retrievers_tpu_torch.models import T5Config
    from reranking_multimodal_retrievers_tpu_torch.models.init import materialize_
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import Blip2DecoderRerankModel

    t0 = time.perf_counter()
    cfg = _decoder_config(T5Config.flan_t5_xl(use_pallas_attention=True,
                                              position_bias_bf16=True), T5_YES_NO)
    model = Blip2DecoderRerankModel(cfg, device="meta")
    for m in model.modules():
        m.__dict__.pop("init_std", None)
    materialize_(model, "cuda", torch.bfloat16,
                 torch.Generator(device="cuda").manual_seed(SEED), 0.02)
    ids, am, _, pix = _decoder_inputs(False, 30000)
    n = DECODER_CHECK
    p_k2 = make_decoder_rerank_fn(model.eval(), chunk_size=n)(ids[:n], am[:n],
                                                              pix.to(torch.bfloat16))
    p_bf16, p_fp32 = _plain_p_yes(model, ids[:n], am[:n], pix)
    return {"phase": "probe_t5_init_std_0.02", "card": smi, "p_yes_k2_bf16": p_k2.tolist(),
            "p_yes_plain_bf16": p_bf16.tolist(), "p_yes_fp32": p_fp32.tolist(),
            "max_abs_gap_k2_bf16": (p_k2.float() - p_fp32).abs().max().item(),
            "max_abs_gap_plain_bf16": (p_bf16.float() - p_fp32).abs().max().item(),
            "seconds": time.perf_counter() - t0}


def decoder_rerank(family, text_config, chunk, yes_no, vocab_hi, smi, then=None):
    """Phases 5 and 6: a full-width Blip2DecoderRerankModel over
    ``text_config`` (Flan-T5-XL or OPT-2.7b) in bf16 with random weights from
    a seed scores DECODER_K prompts of one image through
    ``make_decoder_rerank_fn`` in chunks of ``chunk`` rows; p(yes) of
    DECODER_CHECK candidates is held against the same weights in fp32 on the
    card without the kernel, and K2's variant against its plain version at
    the LM's launch shape. For T5 the same K2 run with the encoder's head
    bias zeroed must miss fp32 by more than the tolerance (the check sees
    the head bias). ``then(model, ids, am, pix, p_yes)``, if given, runs
    last on the same model and inputs (phases 5b and 6b). Returns (the
    phase's line, K2's line for the kernels line, what ``then`` returned).
    Frees the models before it returns."""
    from reranking_multimodal_retrievers_tpu_torch.engine import make_decoder_rerank_fn
    from reranking_multimodal_retrievers_tpu_torch.models import OPTConfig
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import Blip2DecoderRerankModel
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention, fused_self_attention_reference)

    t0 = time.perf_counter()
    is_opt = isinstance(text_config, OPTConfig)
    cfg = _decoder_config(text_config, yes_no)
    wgen = torch.Generator(device="cuda").manual_seed(SEED)
    model = Blip2DecoderRerankModel(cfg, device="cuda", dtype=torch.bfloat16,
                                    generator=wgen).eval()
    if not is_opt:
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("relative_attention_bias.weight"):
                    p.copy_(torch.randn(p.shape, device="cuda", generator=wgen) * REL_BIAS_STD)
    n_params = sum(p.numel() for p in model.parameters())
    K, L = DECODER_K, DECODER_L
    ids, am, padded, pix = _decoder_inputs(is_opt, vocab_hi)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    fn = make_decoder_rerank_fn(model, chunk_size=chunk)
    reset_counts()
    run_s = []
    for _ in range(2):  # the first run also warms up cuBLAS
        t1 = time.perf_counter()
        p_yes = fn(ids, am, pix.to(torch.bfloat16))
        torch.cuda.synchronize()
        run_s.append(time.perf_counter() - t1)
    launches = read_counts()
    layers = text_config.num_hidden_layers if is_opt else text_config.num_layers
    want_k2 = 2 * layers * (K // chunk)
    check(launches["K2"] == want_k2 and launches["K1"] == launches["K3"] == 0,
          f"{family} launches {launches}, want K2 = {want_k2}")
    check(tuple(p_yes.shape) == (K,) and bool(torch.isfinite(p_yes).all())
          and bool(((p_yes > 0) & (p_yes < 1)).all()), f"{family} p(yes) {p_yes}")

    # K2's variant at the LM's launch shape, and its isolations
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    Lp = L + cfg.blip2.num_query_tokens
    H = text_config.num_attention_heads if is_opt else text_config.num_heads
    hd = text_config.head_dim if is_opt else text_config.d_kv
    q, k, v = (torch.randn(chunk, Lp, H * hd, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    lens = torch.randint(Lp // 2, Lp + 1, (chunk,), device="cuda", generator=gen)
    lens[0] = Lp
    keep = torch.arange(Lp, device="cuda")[None, :] < lens[:, None]
    bias = torch.where(keep, 0.0, -1e9)
    pairs = Lp * Lp
    lines = []
    if is_opt:
        causal = torch.ones(Lp, Lp, dtype=torch.bool, device="cuda").tril()
        pairs_causal = Lp * (Lp + 1) // 2
        lines.append(k2_variant(
            "causal, head_dim 80 (OPT-2.7b)", q, k, v, bias, None, heads=H, scale=hd ** -0.5,
            causal=True, sdpa_mask=causal[None, None] & keep[:, None, None, :],
            flops=4 * chunk * H * pairs_causal * hd))
        lines.append(k2_variant(
            "head_dim 80 alone (not on the path)", q, k, v, bias, None, heads=H,
            scale=hd ** -0.5, causal=False, sdpa_mask=keep[:, None, None, :],
            flops=4 * chunk * H * pairs * hd))
        q64, k64, v64 = (x[..., :H * 64] for x in (q, k, v))
        q64, k64, v64 = (x.contiguous() for x in (q64, k64, v64))
        lines.append(k2_variant(
            "causal at head_dim 64 alone (not on the path)", q64, k64, v64, bias, None, heads=H,
            scale=0.125, causal=True, sdpa_mask=causal[None, None] & keep[:, None, None, :],
            flops=4 * chunk * H * pairs_causal * 64))
    else:
        head_bias = torch.randn(H, Lp, Lp, device="cuda", generator=gen).to(torch.bfloat16)
        # T5 takes sm_scale 1: unscaled q gives scores of std 8, near-argmax
        # attention; checked here, timed below at scores of order 1
        got = fused_self_attention(q, k, v, bias, head_bias, num_heads=H, sm_scale=1.0)
        ref = fused_self_attention_reference(q, k, v, bias, head_bias, num_heads=H, sm_scale=1.0)
        diff = (got.float() - ref.float()).abs()
        err_big = diff.max().item()
        over = (diff - K2_TOL - K2_RTOL_BIG * ref.float().abs()).max().item()
        check(bool(torch.isfinite(got).all()) and over <= 0,
              f"K2 head_bias at scores of std 8: max |diff| {err_big} over "
              f"{K2_TOL} + {K2_RTOL_BIG} |ref| by {over}")
        del got, ref, diff
        q = q * 0.125
        lines.append(k2_variant(
            "head_bias bf16 (Flan-T5-XL)", q, k, v, bias, head_bias, heads=H, scale=1.0,
            causal=False, sdpa_mask=(bias[:, None, None, :] + head_bias[None].float()
                                     ).to(torch.bfloat16),
            flops=4 * chunk * H * pairs * hd))
        lines.append(k2_variant(
            "head_bias fp32 (not on the path)", q, k, v, bias, head_bias.float(), heads=H,
            scale=1.0, causal=False, sdpa_mask=(bias[:, None, None, :] + head_bias[None].float()
                                                ).to(torch.bfloat16),
            flops=4 * chunk * H * pairs * hd))
        lines[0]["max_abs_err_scores_std_8"] = err_big
    for line in lines:
        emit({"phase": "kernel_check", "kernel": "K2 fused_self_attention", "card": smi, **line})
    k2 = lines[0]
    del q, k, v
    # the same weights without the kernel: in fp32 (the check) and, sharing
    # the bf16 tensors, in bf16 (information: the kernel's share of the gap)
    t1 = time.perf_counter()
    n = DECODER_CHECK
    p_bf16_plain, want = _plain_p_yes(model, ids[:n], am[:n], pix)
    err = (p_yes[:n].float() - want).abs().max().item()
    nobias_err = None
    if not is_opt:  # the check's power: K2 without the head bias must miss fp32
        rel_bias = model.get_parameter(ENC_REL_BIAS)
        kept = rel_bias.detach().clone()
        with torch.no_grad():
            rel_bias.zero_()
        p_nobias = make_decoder_rerank_fn(model, chunk_size=n)(ids[:n], am[:n],
                                                               pix.to(torch.bfloat16))
        nobias_err = (p_nobias.float() - want).abs().max().item()
        with torch.no_grad():
            rel_bias.copy_(kept)
        del kept
    check_s = time.perf_counter() - t1
    del fn
    k2_share = launches["K2"] / 2 * k2["ms"] / 1e3 / run_s[-1]
    line = {"phase": f"rerank_{family}", "card": smi, "params": n_params, "candidates": K,
            "seq_len": L, "prefix": cfg.blip2.num_query_tokens, "chunk_rows": chunk,
            "padded_prompts": len(padded),
            "setup_seconds": setup_s, "run_seconds": run_s, "candidates_per_s": K / run_s[-1],
            "p_yes_checked": p_yes[:n].tolist(), "p_yes_fp32": want.tolist(),
            "max_abs_err_vs_fp32": err, "tol": P_YES_TOL,
            "p_yes_bf16_without_kernel": p_bf16_plain.tolist(),
            "max_abs_err_vs_fp32_without_head_bias": nobias_err,
            "p_yes_spread": [p_yes.min().item(), p_yes.max().item()],
            "k2_launches_per_run": launches["K2"] // 2, "k2_ms": k2["ms"],
            "k2_share_of_run": k2_share, "fp32_check_seconds": check_s, "launches": launches,
            "seconds": time.perf_counter() - t0}
    blind = nobias_err is not None and nobias_err <= P_YES_TOL
    if err > P_YES_TOL or blind:
        emit(line)
    check(err <= P_YES_TOL, f"{family} p(yes) {p_yes[:n].tolist()} vs fp32 {want.tolist()}")
    check(not blind, f"{family} p(yes) without the head bias within {nobias_err} of fp32")
    gc.collect()
    extra = None if then is None else then(model, ids, am, pix, p_yes)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return line, {**k2, "launches": launches["K2"]}, extra


def grad_snapshots(model, names):
    """Copies of the named leaves' gradients, taken as the backward
    accumulates them (inside the train step). Returns (dict, hooks)."""
    seen = {}

    def keep(name):
        return lambda p: seen.__setitem__(name, p.grad.detach().clone())

    return seen, [model.get_parameter(n).register_post_accumulate_grad_hook(keep(n))
                  for n in names]


def loss_rel_err(card, cpu):
    """|card - cpu| over max(1, |cpu|), the share TRAIN_LOSS_TOL limits."""
    return abs(card - cpu) / max(1.0, abs(cpu))


def grad_rel_err(g_card, g_cpu):
    """The largest |card - cpu| of a leaf's gradient over the leaf's largest
    |g| on the CPU, the share TRAIN_GRAD_TOL limits."""
    g_cpu = g_cpu.double()
    return ((g_card.cpu().double() - g_cpu).abs().max() / g_cpu.abs().max()).item()


def check_first_update(name, lr, before, after_card, g_card, after_cpu, g_cpu):
    """A named leaf after one step on the card and on the CPU from the same
    weights ``before``. Gradients within TRAIN_GRAD_TOL of the leaf's
    largest |g|. Adam's first step moves an element by ``-lr * g / (|g| +
    eps)`` (weight decay 0), so each side's update must differ from the
    other's by at most what their gradients imply, plus one fp32 rounding of
    ``p + update`` on each side. Returns the leaf's line."""
    rel = grad_rel_err(g_card, g_cpu)
    check(rel <= TRAIN_GRAD_TOL, f"{name}: gradient on the card off the CPU's by {rel} of "
          f"its largest |g| > {TRAIN_GRAD_TOL}")
    g_card, g_cpu = g_card.cpu().double(), g_cpu.double()
    g_err = (g_card - g_cpu).abs().max().item()
    g_max = g_cpu.abs().max().item()
    b = before.double()
    u_card, u_cpu = after_card.cpu().double() - b, after_cpu.double() - b

    def adam(g):
        return -lr * g / (g.abs() + ADAM_EPS)

    rounding = 2 * torch.finfo(torch.float32).eps * b.abs().max().item() + 1e-5 * lr
    excess = ((u_card - u_cpu).abs() - (adam(g_card) - adam(g_cpu)).abs() - rounding).max()
    check(excess.item() <= 0, f"{name}: update on the card off the CPU's by {excess.item()} "
          "more than their gradients allow")
    moved = (u_card - adam(g_card)).abs().max().item()
    check(moved <= rounding, f"{name}: the card's update is not Adam's first step ({moved})")
    du = (u_card - u_cpu).abs()
    return {"grad_max_abs_err": g_err, "grad_max": g_max, "grad_tol": TRAIN_GRAD_TOL * g_max,
            "update_max_abs_diff_over_lr": du.max().item() / lr,
            "update_share_off_by_1e-3_lr": (du > 1e-3 * lr).double().mean().item()}


def flmr_train_config():
    from reranking_multimodal_retrievers_tpu_torch.models import (
        BertConfig, CLIPVisionConfig, FLMRConfig)

    return FLMRConfig(text_config=BertConfig(), vision_config=CLIPVisionConfig(), dim=128,
                      mapping_network_prefix_length=32, use_transformer_mapping_network=True,
                      transformer_mapping_num_hidden_layers=1)


def flmr_optimizer(model, **kw):
    """bench.py:677-682's optimizer: AdamW, lr 1e-5, the mapping group at
    1e-4, the vision tower frozen."""
    from reranking_multimodal_retrievers_tpu_torch.training import make_optimizer

    return make_optimizer(model, optimizer_name="AdamW", lr=1e-5, mapping_network_lr=1e-4,
                          frozen_patterns=("vision_encoder",),
                          group_patterns=("vision_projection", "transformer_mapping"), **kw)


FLMR_CHECKED_LEAVES = (
    "context_text_encoder.bert_model.encoder.layer.0.attention.self.query.weight",
    "transformer_mapping_network.layer.0.crossattention.self.query.weight",
    "transformer_mapping_output_linear.weight",
    "context_vision_projection.model.2.weight",
)


def flmr_training(smi):
    """Phase 8. Returns the phase's line."""
    from reranking_multimodal_retrievers_tpu_torch.models import FLMRModelForRetrieval
    from reranking_multimodal_retrievers_tpu_torch.training import TrainState, make_train_step
    from reranking_multimodal_retrievers_tpu_torch.training.checkpointing import (
        CheckpointManager)
    from reranking_multimodal_retrievers_tpu_torch.training.train_state import grads_finite

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = flmr_train_config()
    model = FLMRModelForRetrieval(cfg, device="cuda",
                                  generator=torch.Generator(device="cuda").manual_seed(SEED))
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(SEED)
    B, NW, LQ, LD = TRAIN_B, TRAIN_NWAY, TRAIN_LQ, TRAIN_LD
    host = dict(
        query_input_ids=torch.as_tensor(rng.integers(1000, 29000, size=(B, LQ))),
        query_attention_mask=torch.ones(B, LQ, dtype=torch.long),
        query_pixel_values=torch.as_tensor(rng.normal(size=(B, 3, 224, 224)).astype(np.float32)),
        context_input_ids=torch.as_tensor(rng.integers(1000, 29000, size=(B * NW, LD))),
        context_attention_mask=torch.ones(B * NW, LD, dtype=torch.long))
    batch = {k: v.cuda() for k, v in host.items()}
    n_params = sum(p.numel() for p in model.parameters())
    setup_s = time.perf_counter() - t0

    # -- one step on a 2-query sub-batch, card against CPU (constant lr: no
    # warmup, so that the step moves the weights)
    t1 = time.perf_counter()
    sub = {k: v[:TRAIN_SUB * (NW if k.startswith("context") else 1)] for k, v in host.items()}
    after, grads, metrics = {}, {}, {}
    cpu = FLMRModelForRetrieval(cfg, device="meta")
    cpu.load_state_dict({k: v.clone() for k, v in init.items()}, assign=True)
    labels = None

    def sub_step(side, m, b):
        nonlocal labels
        opt, sched, labels = flmr_optimizer(m)
        seen, hooks = grad_snapshots(m, FLMR_CHECKED_LEAVES)
        _, met = make_train_step(m, opt, sched)(TrainState.create(m, opt, sched), b)
        for h in hooks:
            h.remove()
        after[side] = {n: m.get_parameter(n).detach().clone() for n in FLMR_CHECKED_LEAVES}
        grads[side], metrics[side] = seen, {k: float(v) for k, v in met.items()}

    sub_card = {k: v.cuda() for k, v in sub.items()}
    sub_step("card", model, sub_card)
    sub_step("cpu", cpu, sub)
    del cpu
    # the control: the same card step with TF32 on in cuBLAS and cuDNN
    model.load_state_dict(init)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        sub_step("tf32", model, sub_card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    readings = {side: {**{k: loss_rel_err(metrics[side][k], metrics["cpu"][k])
                          for k in ("loss", "ib_loss")},
                       **{n: grad_rel_err(grads[side][n], grads["cpu"][n])
                          for n in FLMR_CHECKED_LEAVES}}
                for side in ("card", "tf32")}
    for key in ("loss", "ib_loss"):
        check(readings["card"][key] <= TRAIN_LOSS_TOL,
              f"step 0 {key} on the card {metrics['card'][key]} vs CPU fp32 "
              f"{metrics['cpu'][key]}")
    lr = {"main": 1e-5, "mapping": 1e-4}
    leaves = {n: check_first_update(n, lr[labels[n]], init[n], after["card"][n],
                                    grads["card"][n], after["cpu"][n], grads["cpu"][n])
              for n in FLMR_CHECKED_LEAVES}
    caught = [k for k, r in readings["tf32"].items()
              if r > (TRAIN_LOSS_TOL if k in ("loss", "ib_loss") else TRAIN_GRAD_TOL)]
    check(caught, f"the TF32 control passes every limit: {readings['tf32']}")
    sub_s = time.perf_counter() - t1

    # -- 20 steps on the fixed batch from the same initial weights
    model.load_state_dict(init)
    opt, sched, labels = flmr_optimizer(model, scheduler="linear", num_warmup_steps=10,
                                        num_training_steps=1000)
    step = make_train_step(model, opt, sched, loss_key="ib_loss")
    state = TrainState.create(model, opt, sched)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if labels[n] == "frozen"}
    check(frozen and all("vision_encoder" in n for n in frozen), "no frozen vision tower")
    reset_counts()
    ib, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, met = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        ib.append(float(met["ib_loss"]))
        check(float(met["grads_finite"]) == 1.0 and np.isfinite(ib[-1]), f"step {state.step}: {met}")
    launches = read_counts()
    check(sum(launches.values()) == 0, f"training launched kernels: {launches}")
    check(ib[-1] < ib[0], f"ib_loss did not fall over {TRAIN_STEPS} steps: {ib}")
    check(all(torch.equal(p, frozen[n]) for n, p in model.named_parameters() if n in frozen),
          "a frozen vision-tower leaf changed")
    peak = torch.cuda.max_memory_allocated()
    run_ms = float(np.mean(step_ms[TRAIN_WARMUP:]))

    # -- the NaN guard: one NaN pixel
    t1 = time.perf_counter()
    bad = dict(batch)
    bad["query_pixel_values"] = batch["query_pixel_values"].clone()
    bad["query_pixel_values"][0, 0, 0, 0] = float("nan")
    params_before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = [{k: v.clone() for k, v in s.items()} for s in opt.state.values()]
    lr_before, count_before = sched.get_last_lr(), sched.last_epoch
    state, met = step(state, bad)
    check(float(met["grads_finite"]) == 0.0, f"NaN batch: grads_finite {met['grads_finite']}")
    check(all(torch.equal(v, params_before[k]) for k, v in model.state_dict().items()),
          "NaN batch: parameters changed")
    check(all(torch.equal(v, o[k]) for s, o in zip(opt.state.values(), opt_before)
              for k, v in s.items()), "NaN batch: optimizer state changed")
    check(sched.get_last_lr() == lr_before and sched.last_epoch == count_before,
          "NaN batch: the schedule moved")
    state, met = step(state, batch)
    check(float(met["grads_finite"]) == 1.0
          and any(not torch.equal(v, params_before[k]) for k, v in model.state_dict().items()),
          f"the clean step after the NaN batch did not update: {met}")
    del params_before, opt_before
    nan_s = time.perf_counter() - t1

    # -- checkpoint round trip: save, restore into a fresh model and
    # optimizer, one more step from each
    t1 = time.perf_counter()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        mgr = CheckpointManager(str(CKPT_DIR), monitor="ib_loss", mode="min")
        path = mgr.save(state, step=state.step, metrics={"ib_loss": float(met["ib_loss"])})
        ckpt_bytes = sum(f.stat().st_size for f in Path(path).iterdir())
        fresh = FLMRModelForRetrieval(
            cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
        f_opt, f_sched, _ = flmr_optimizer(fresh, scheduler="linear", num_warmup_steps=10,
                                           num_training_steps=1000)
        restored = CheckpointManager.restore(mgr.resolve(),
                                             TrainState.create(fresh, f_opt, f_sched))
        check(restored.step == state.step, f"restored step {restored.step} != {state.step}")
        state, _ = step(state, batch)
        restored, _ = make_train_step(fresh, f_opt, f_sched)(restored, batch)
        check(all(torch.equal(a, b) for a, b in zip(model.parameters(), fresh.parameters())),
              "the step after a checkpoint round trip differs from the original's")
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    del fresh, f_opt, f_sched, restored
    ckpt_s = time.perf_counter() - t1

    # -- where a step's time goes (after the checks; these calls train on)
    def fwd():
        return model(**batch, num_negative_examples=1).in_batch_negative_loss

    def fwd_bwd():
        fwd().backward()
        opt.zero_grad(set_to_none=True)

    fwd_bwd()
    loss = fwd()
    loss.backward()
    parts = {"forward_ms": cuda_ms(fwd, 3), "forward_backward_ms": cuda_ms(fwd_bwd, 3)}
    loss = fwd()
    loss.backward()
    parts["nan_guard_ms"] = cuda_ms(lambda: bool(grads_finite(model, loss)), 5)
    parts["optimizer_ms"] = cuda_ms(opt.step, 3)
    opt.zero_grad(set_to_none=True)
    del model, opt, sched, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": "train_flmr", "card": smi, "params": n_params,
            "batch": {"queries": B, "nway": NW, "query_tokens": LQ, "doc_tokens": LD,
                      "image": 224},
            "allow_tf32": {"cuda_matmul": torch.backends.cuda.matmul.allow_tf32,
                           "cudnn": torch.backends.cudnn.allow_tf32},
            "sub_batch_queries": TRAIN_SUB, "loss_tol": TRAIN_LOSS_TOL,
            "grad_tol": TRAIN_GRAD_TOL,
            "step0_vs_cpu": {k: [metrics["card"][k], metrics["cpu"][k]]
                             for k in ("loss", "ib_loss")},
            "rel_err_vs_cpu": readings["card"], "tf32_control_rel_err_vs_cpu": readings["tf32"],
            "tf32_control_caught_by": caught,
            "leaves_vs_cpu": leaves, "sub_batch_seconds": sub_s,
            "steps": TRAIN_STEPS, "ib_loss": ib, "step_ms": step_ms,
            "flmr_train_examples_per_sec": B / (run_ms / 1e3),
            "step_ms_after_warmup": run_ms, "warmup_steps": TRAIN_WARMUP,
            "step_parts": parts, "peak_memory_bytes": peak,
            "nan_guard_checked": True, "nan_guard_seconds": nan_s,
            "checkpoint_bytes": ckpt_bytes, "checkpoint_bitwise_resume": True,
            "checkpoint_seconds": ckpt_s, "launches": launches,
            "setup_seconds": setup_s, "seconds": time.perf_counter() - t0}


def rerank_training(smi):
    """Phase 8b: the monoPreFLMR reranker's train step. Returns the line."""
    from reranking_multimodal_retrievers_tpu_torch.models import BertConfig
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import (
        FullContextRerankModel, RerankConfig)
    from reranking_multimodal_retrievers_tpu_torch.training import (
        TrainState, make_optimizer, make_rerank_train_step)

    t0 = time.perf_counter()
    L, LQT = 512, 32
    B, NW = RERANK_TRAIN_B, RERANK_TRAIN_NWAY
    rcfg = RerankConfig(flmr=flmr_train_config(), cross_encoder=BertConfig(
        num_hidden_layers=1, max_position_embeddings=768), loss_fn="BCE",
        max_query_length=LQT, max_decoder_source_length=L)
    model = FullContextRerankModel(rcfg, device="cuda",
                                   generator=torch.Generator(device="cuda").manual_seed(SEED))
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(SEED + 8)
    ids = rng.integers(1000, 29000, size=(B * NW, L))
    am = np.ones((B * NW, L), np.int64)
    for r in range(B * NW):  # candidates of 100-480 tokens after the query
        n = int(rng.integers(100, L - LQT + 1))
        ids[r, LQT + n:], am[r, LQT + n:] = 0, 0
    tt = np.zeros((B * NW, L), np.int64)
    tt[:, LQT:] = 1
    host = dict(input_ids=torch.as_tensor(ids), attention_mask=torch.as_tensor(am),
                token_type_ids=torch.as_tensor(tt),
                query_pixel_values=torch.as_tensor(
                    rng.normal(size=(B, 3, 224, 224)).astype(np.float32)))
    batch = {k: v.cuda() for k, v in host.items()}
    leaf = "reranker.bert_model.encoder.layer.0.attention.self.query.weight"
    after, grads, losses, labels = {}, {}, {}, None
    cpu = FullContextRerankModel(rcfg, device="meta")
    cpu.load_state_dict({k: v.clone() for k, v in init.items()}, assign=True)
    t1 = time.perf_counter()
    for side, m, b in (("card", model, batch), ("cpu", cpu, host)):
        opt, sched, labels = make_optimizer(m, optimizer_name="AdamW", lr=1e-4,
                                            frozen_patterns=("vision_encoder",))
        seen, hooks = grad_snapshots(m, [leaf])
        _, met = make_rerank_train_step(m, opt, sched, num_negative_examples=NW - 1)(
            TrainState.create(m, opt, sched), b)
        for h in hooks:
            h.remove()
        after[side], grads[side], losses[side] = (m.get_parameter(leaf).detach().clone(),
                                                  seen[leaf], float(met["loss"]))
    cpu_s = time.perf_counter() - t1
    check(loss_rel_err(losses["card"], losses["cpu"]) <= TRAIN_LOSS_TOL,
          f"rerank loss on the card {losses['card']} vs CPU fp32 {losses['cpu']}")
    leaf_line = check_first_update(leaf, 1e-4, init[leaf], after["card"], grads["card"],
                                   after["cpu"], grads["cpu"])
    del cpu
    frozen = [n for n, lab in labels.items() if lab == "frozen"]
    check(frozen and all(torch.equal(model.get_parameter(n).cpu(), init[n]) for n in frozen),
          "a frozen leaf of the reranker changed")

    opt, sched, _ = make_optimizer(model, optimizer_name="AdamW", lr=1e-4,
                                   frozen_patterns=("vision_encoder",))
    step = make_rerank_train_step(model, opt, sched, num_negative_examples=NW - 1)
    state = TrainState.create(model, opt, sched)
    reset_counts()
    step_ms = cuda_ms(lambda: step(state, batch), 5)
    launches = read_counts()
    check(sum(launches.values()) == 0, f"reranker training launched kernels: {launches}")
    check(all(torch.equal(model.get_parameter(n).cpu(), init[n]) for n in frozen),
          "a frozen leaf of the reranker changed over the timed steps")
    del model, opt, sched, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": "train_rerank", "card": smi, "rows": B * NW, "queries": B, "nway": NW,
            "seq_len": L, "loss_fn": "BCE", "loss_card": losses["card"],
            "loss_cpu": losses["cpu"], "loss_tol": TRAIN_LOSS_TOL, "leaf": leaf,
            "leaf_vs_cpu": leaf_line, "frozen_leaves_bitwise": len(frozen),
            "step_ms": step_ms, "steps_per_sec": 1e3 / step_ms, "cpu_seconds": cpu_s,
            "launches": launches, "seconds": time.perf_counter() - t0}


def int8_linear_backward(smi):
    """Phase 8b's W8A8 check: ``Int8Linear`` at BERT-base width (768 ->
    3072, 512 rows) on the card; its backward must be the fp32 ``x @ w``
    cotangents. Returns the line."""
    from reranking_multimodal_retrievers_tpu_torch.ops.quant import Int8Linear

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    lin = Int8Linear(768, 3072, device="meta").to_empty(device="cuda")  # no draw here
    with torch.no_grad():
        lin.weight.normal_(0.0, 0.02, generator=gen)
        lin.bias.zero_()
    x = torch.randn(512, 768, device="cuda", generator=gen).requires_grad_(True)
    g = torch.randn(512, 3072, device="cuda", generator=gen)
    lin(x).backward(g)
    want_dx, want_dw = g @ lin.weight, g.t() @ x.detach()
    err_dx = (x.grad - want_dx).abs().max().item() / want_dx.abs().max().item()
    err_dw = (lin.weight.grad - want_dw).abs().max().item() / want_dw.abs().max().item()
    check(err_dx <= INT8_GRAD_TOL and err_dw <= INT8_GRAD_TOL,
          f"Int8Linear backward off x @ w's: dx {err_dx}, dw {err_dw}")
    with torch.no_grad():
        fwd_gap = (lin(x) - x @ lin.weight.t() - lin.bias).abs().max().item()
    check(fwd_gap > 0, "Int8Linear's forward is the fp32 product: not W8A8")
    return {"phase": "int8_linear_backward", "card": smi, "shape": [512, 768, 3072],
            "rel_err_dx": err_dx, "rel_err_dw": err_dw, "tol": INT8_GRAD_TOL,
            "forward_gap_vs_fp32": fwd_gap}


def _interaction_config(interaction_type, serving=True):
    from reranking_multimodal_retrievers_tpu_torch.models import BertConfig
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import InteractionRerankConfig

    kw = dict(attention_scores_bf16=True, gelu_approximate=True,
              use_pallas_attention=True) if serving else {}
    return InteractionRerankConfig(
        cross_encoder=BertConfig(num_hidden_layers=INTER_LAYERS,
                                 max_position_embeddings=INTER_LQ + INTER_LD, **kw),
        interaction_type=interaction_type,
        loss_fn="BCE" if serving else "negative_sampling")


def _rerank_queries(model, q, qm, d, dm):
    """One forward of the K candidates of each query (``d [B, K, Ld, dim]``),
    as bench.py's scan does: [B, K] logits."""
    K = d.shape[1]
    with torch.inference_mode():
        return torch.stack([
            model(q[i:i + 1], d[i], K - 1, qm[i:i + 1], dm[i]).logits.reshape(K)
            for i in range(q.shape[0])])


def _cpu_copy(model, cfg):
    """The same weights in fp32 on the CPU."""
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import InteractionRerankModel

    cpu = InteractionRerankModel(cfg, device="meta")
    cpu.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()}, assign=True)
    return cpu


def interaction_rerank(name, model, cfg, q, qm, d, dm, want_k2, smi):
    """Phases 9a-9c: ``model`` reranks each query's candidates (one warm-up
    pass, then the counted and timed pass); the first four candidates of the
    first query are recomputed in fp32 on the CPU. Returns the line."""
    t0 = time.perf_counter()
    B, K = d.shape[:2]
    _rerank_queries(model, q, qm, d, dm)  # warms up cuBLAS
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    logits = _rerank_queries(model, q, qm, d, dm)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = read_counts()
    check(launches == {"K1": 0, "K2": want_k2, "K3": 0, "K2f32": 0, "K2any": 0},
          f"{name} launches {launches}, want K2 = {want_k2} and no other")
    check(tuple(logits.shape) == (B, K) and bool(torch.isfinite(logits.float()).all()),
          f"{name} logits {tuple(logits.shape)}")
    t2 = time.perf_counter()
    cpu = _cpu_copy(model, cfg)
    n = 4
    with torch.inference_mode():
        want = cpu(q[:1].float().cpu(), d[0, :n].float().cpu(), n - 1, qm[:1].cpu(),
                   dm[0, :n].cpu()).logits.reshape(n)
    got = logits[0, :n].float().cpu()
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, atol=INTER_ATOL, rtol=INTER_RTOL),
          f"{name} logits {got.tolist()} vs CPU fp32 {want.tolist()}")
    return {"phase": name, "card": smi, "queries": B, "candidates": K,
            "query_tokens": q.shape[1], "doc_tokens": d.shape[2],
            "interaction_type": cfg.interaction_type, "run_seconds": run_s,
            "candidates_per_s": B * K / run_s, "max_abs_err_vs_cpu_fp32": err,
            "tol": [INTER_ATOL, INTER_RTOL], "logit_std": logits.float().std().item(),
            "cpu_check_seconds": time.perf_counter() - t2, "launches": launches,
            "seconds": time.perf_counter() - t0}


def _k2_interaction(name, keep, heads, hd, gen, smi):
    """K2 against its plain version at an interaction launch shape: random
    q/k/v ``[K, L, heads x hd]`` with the key bias of ``keep [K, L]``.
    Emits and returns the variant's line."""
    K, L = keep.shape
    q, k, v = (torch.randn(K, L, heads * hd, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    line = k2_variant(name, q, k, v, torch.where(keep, 0.0, -1e9), None, heads=heads,
                      scale=hd ** -0.5, causal=False, sdpa_mask=keep[:, None, None, :],
                      flops=4 * K * heads * L * L * hd)
    emit({"phase": "kernel_check", "kernel": "K2 fused_self_attention", "card": smi, **line})
    return line


def interaction_phases(retrieved, smi):
    """Phase 9a-9c: the ModPreFLMR-BERT interaction reranker (CrossEncoder
    type, 9a), the same traffic through MORES (9b), and phase 3's top-100
    reranked straight from the index (9c). ``retrieved`` holds phase 3's
    query matrices and mask and its candidates' token matrices and masks.
    Returns (the lines, K2's lines for the kernels line by phase)."""
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import InteractionRerankModel

    lines = []
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 10)
    B, K, LQ, LD, DIM = INTER_B, INTER_K, INTER_LQ, INTER_LD, INTER_DIM
    q = torch.as_tensor(rng.normal(size=(B, LQ, DIM)).astype(np.float32)).cuda().bfloat16()
    d = torch.empty(B, K, LD, DIM, dtype=torch.bfloat16, device="cuda")
    for i in range(B):
        d[i] = torch.as_tensor(rng.normal(size=(K, LD, DIM)).astype(np.float32)).cuda()
    qm = torch.ones(B, LQ, dtype=torch.int32, device="cuda")
    dm = torch.ones(B, K, LD, dtype=torch.int32, device="cuda")
    setup_s = time.perf_counter() - t0

    # 9a. CrossEncoder: K2 at [K, LQ + LD, 12 x 64] in every layer
    cfg = _interaction_config("CrossEncoder")
    model = InteractionRerankModel(cfg, device="cuda", dtype=torch.bfloat16,
                                   generator=torch.Generator(device="cuda").manual_seed(SEED)).eval()
    line = interaction_rerank("rerank_interaction_cross_encoder", model, cfg, q, qm, d, dm,
                              INTER_LAYERS * B, smi)
    lines.append({**line, "setup_seconds": setup_s})
    H, HD = cfg.cross_encoder.num_attention_heads, cfg.cross_encoder.head_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    L = LQ + LD
    tlen = torch.randint(LQ, L + 1, (K,), device="cuda", generator=gen)
    keep = torch.arange(L, device="cuda")[None, :] < tlen[:, None]  # padded doc tails
    k2 = {"9a": _k2_interaction("key bias L=640 (interaction CrossEncoder, 9a)", keep, H, HD,
                                gen, smi)}

    # 9c. phase 3's queries and their top-100 straight from the index
    Qm, q_mask, cand_emb, cand_mask = retrieved
    line = interaction_rerank("rerank_interaction_retrieved", model, cfg, Qm, q_mask,
                              cand_emb, cand_mask, INTER_LAYERS * Qm.shape[0], smi)
    line["seq_len"] = Qm.shape[1] + cand_emb.shape[2]
    retrieved_line = line
    # K2 at 9c's launch shape, with the first query's own key mask (its
    # query tokens, then each candidate's padded doc tokens)
    keep = torch.cat([q_mask[:1].bool().expand(cand_mask.shape[1], -1), cand_mask[0].bool()], 1)
    k2["9c"] = _k2_interaction("key bias L=369 (interaction CrossEncoder on retrieved docs, 9c)",
                               keep, H, HD, gen, smi)
    del model
    gc.collect()

    # 9b. MORES on 9a's traffic: no kernel on this path
    cfg = _interaction_config("MORES")
    model = InteractionRerankModel(cfg, device="cuda", dtype=torch.bfloat16,
                                   generator=torch.Generator(device="cuda").manual_seed(SEED)).eval()
    lines.append(interaction_rerank("rerank_interaction_mores", model, cfg, q, qm, d, dm, 0,
                                    smi))
    lines.append(retrieved_line)
    del model, q, d
    gc.collect()
    torch.cuda.empty_cache()
    k2["9a"]["launches"] = lines[0]["launches"]["K2"]
    k2["9c"]["launches"] = retrieved_line["launches"]["K2"]
    return lines, k2


def mores_training(smi):
    """Phase 9d: one MORES training step at 9b's width in fp32 (negative
    sampling over 2 queries x (1 + 2) candidates, AdamW at 1e-4) through
    ``make_rerank_train_step``, against the same step on the CPU; then
    steps/s. Returns the line."""
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import InteractionRerankModel
    from reranking_multimodal_retrievers_tpu_torch.training import (
        TrainState, make_optimizer, make_rerank_train_step)

    t0 = time.perf_counter()
    B, NW = MORES_TRAIN_B, MORES_TRAIN_NWAY
    cfg = _interaction_config("MORES", serving=False)
    model = InteractionRerankModel(cfg, device="cuda",
                                   generator=torch.Generator(device="cuda").manual_seed(SEED))
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(SEED + 12)
    qm = np.ones((B, INTER_LQ), np.int32)
    dm = np.ones((B * NW, INTER_LD), np.int32)
    for r in range(B * NW):  # candidates of 40-100% of the doc tokens
        dm[r, int(rng.integers(INTER_LD * 2 // 5, INTER_LD + 1)):] = 0
    qm[1, INTER_LQ * 3 // 4:] = 0
    host = dict(query_late_interaction=torch.as_tensor(
                    rng.normal(size=(B, INTER_LQ, INTER_DIM)).astype(np.float32)),
                context_late_interaction=torch.as_tensor(
                    rng.normal(size=(B * NW, INTER_LD, INTER_DIM)).astype(np.float32)),
                query_mask=torch.as_tensor(qm), context_mask=torch.as_tensor(dm))
    batch = {k: v.cuda() for k, v in host.items()}
    leaf = "reranker.layers.0.crossattention.self.query.weight"
    after, grads, losses = {}, {}, {}
    cpu = InteractionRerankModel(cfg, device="meta")
    cpu.load_state_dict({k: v.clone() for k, v in init.items()}, assign=True)
    t1 = time.perf_counter()
    for side, m, b in (("card", model, batch), ("cpu", cpu, host)):
        opt, sched, _ = make_optimizer(m, optimizer_name="AdamW", lr=1e-4)
        seen, hooks = grad_snapshots(m, [leaf])
        _, met = make_rerank_train_step(m, opt, sched, num_negative_examples=NW - 1)(
            TrainState.create(m, opt, sched), b)
        for h in hooks:
            h.remove()
        after[side], grads[side], losses[side] = (m.get_parameter(leaf).detach().clone(),
                                                  seen[leaf], float(met["loss"]))
    cpu_s = time.perf_counter() - t1
    del cpu
    check(loss_rel_err(losses["card"], losses["cpu"]) <= TRAIN_LOSS_TOL,
          f"MORES loss on the card {losses['card']} vs CPU fp32 {losses['cpu']}")
    leaf_line = check_first_update(leaf, 1e-4, init[leaf], after["card"], grads["card"],
                                   after["cpu"], grads["cpu"])

    opt, sched, _ = make_optimizer(model, optimizer_name="AdamW", lr=1e-4)
    step = make_rerank_train_step(model, opt, sched, num_negative_examples=NW - 1)
    state = TrainState.create(model, opt, sched)
    reset_counts()
    windows = [cuda_ms(lambda: step(state, batch), MORES_WINDOW_STEPS,
                       warmup=MORES_WARMUP if w == 0 else 0) for w in range(MORES_WINDOWS)]
    step_ms = float(np.median(windows))
    launches = read_counts()
    check(sum(launches.values()) == 0, f"MORES training launched kernels: {launches}")
    del model, opt, sched, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": "train_interaction_mores", "card": smi, "rows": B * NW, "queries": B,
            "nway": NW, "query_tokens": INTER_LQ, "doc_tokens": INTER_LD,
            "loss_fn": "negative_sampling", "loss_card": losses["card"],
            "loss_cpu": losses["cpu"], "loss_tol": TRAIN_LOSS_TOL, "leaf": leaf,
            "leaf_vs_cpu": leaf_line, "warmup_steps": MORES_WARMUP,
            "window_steps": MORES_WINDOW_STEPS, "window_step_ms": windows,
            "step_ms": step_ms, "steps_per_sec": 1e3 / step_ms,
            "cpu_seconds": cpu_s, "launches": launches, "seconds": time.perf_counter() - t0}


def best_ms(fn, reps=3):
    """The best of ``reps`` timed calls of ``fn`` after one warm-up call, each
    timed with CUDA events (``fn`` ends in a host copy)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def recall_at_k(ids, exact_ids):
    """The mean share of each row of ``exact_ids`` found in the same row of
    ``ids``."""
    return float(np.mean([len(set(map(int, a)) & set(map(int, b))) / len(b)
                          for a, b in zip(ids, exact_ids)]))


def same_top_k(got_vals, got_ids, want_vals, want_ids, atol, rtol):
    """Values within ``atol + rtol * |value|`` rank by rank; an id may differ
    from the reference's only between docs whose reference values lie within
    that tolerance (an order swap), or at the boundary for a doc within it of
    the reference's last value. Returns the largest |value difference|."""
    err = float(np.abs(got_vals - want_vals).max())
    check(np.allclose(got_vals, want_vals, atol=atol, rtol=rtol),
          f"top-k values off by {err}")
    for gv, gi, wv, wi in zip(got_vals, got_ids, want_vals, want_ids):
        rank = {int(d): r for r, d in enumerate(wi)}
        for r, d in enumerate(gi):
            if d == wi[r]:
                continue
            w = wv[rank[int(d)]] if int(d) in rank else wv[-1]
            ref = wv[r] if int(d) in rank else gv[r]
            check(abs(w - ref) <= atol + rtol * abs(w), f"top-k id {d} at rank {r} is no near-tie")
    return err


def top_k_vs_plain(Q, index, served):
    """The largest gap between the rankings ``served`` for queries ``Q``
    (bf16; each a list of ``{"passage_id", "score"}``, best first) and the
    plain search over ``index``: a doc may stand at a rank only with the
    plain score of that rank (an order swap between near-ties), and its
    served score must be its plain one."""
    from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_cuda import maxsim_scores_reference

    ref_scores = maxsim_scores_reference(Q, index.embeddings, index.mask)
    ref_vals, _ = torch.topk(ref_scores, len(served[0]), dim=1)
    position = {d: i for i, d in enumerate(index.doc_ids)}
    worst = 0.0
    for i, top in enumerate(served):
        got_idx = torch.as_tensor([position[p["passage_id"]] for p in top], device=Q.device)
        swap = (ref_scores[i, got_idx] - ref_vals[i]).abs().max().item()
        scores = torch.as_tensor([p["score"] for p in top], device=Q.device)
        worst = max(worst, swap, (scores - ref_scores[i, got_idx]).abs().max().item())
    return worst


def k1_line(Q, D, M, name):
    """K1 against its plain version at a phase's launch shape, timed beside
    it, with the bound of the same work. Returns the line."""
    from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_cuda import (
        maxsim_scores, maxsim_scores_reference)

    B, LQ, DIM = Q.shape
    N, LD, _ = D.shape
    got = maxsim_scores(Q, D, M)
    ref = maxsim_scores_reference(Q, D, M)
    err = (got - ref).abs().max().item()
    check(torch.allclose(got, ref, atol=PLAID_ATOL, rtol=PLAID_RTOL),
          f"K1 {name}: max |diff| {err}")
    del got, ref
    flops = 2 * B * LQ * N * LD * DIM
    b_ms, b_by = bound(flops, Q.numel() * 2 + D.numel() * 2 + M.numel() + B * N * 4)
    ms = cuda_ms(lambda: maxsim_scores(Q, D, M), 10)
    return dict(variant=name, shape=[[B, LQ, DIM], [N, LD, DIM]], max_abs_err=err,
                tol=[PLAID_ATOL, PLAID_RTOL], ms=ms,
                plain_ms=cuda_ms(lambda: maxsim_scores_reference(Q, D, M), 1),
                bound_ms=b_ms, bound_by=b_by, library_ms=None, share_of_bound=b_ms / ms,
                tflops=flops / (ms * 1e-3) / 1e12)


def compare_codecs(card, cpu, emb):
    """The card's CompressedTokenIndex against the CPU's, compressed from the
    same tokens ``emb``. Returns the comparison's numbers."""
    cent_err = (card.centroids.cpu() - cpu.centroids).abs().max().item()
    check(cent_err <= CENTROID_TOL, f"codec centroids: card off the CPU's by {cent_err}")
    e = emb.cpu().float().reshape(-1, emb.shape[-1])
    valid = cpu.mask.reshape(-1)
    c_card, c_cpu = card.codes.cpu().reshape(-1).long(), cpu.codes.reshape(-1).long()
    code_flips = (c_card != c_cpu) & valid
    if code_flips.any():
        x = e[code_flips]
        gap = ((x * cpu.centroids[c_cpu[code_flips]]).sum(-1)
               - (x * cpu.centroids[c_card[code_flips]]).sum(-1)).abs()
        check(gap.max().item() <= CODE_TIE, f"codec: a code flip is no near-tie ({gap.max()})")
    scale_err = ((card.scales.cpu() - cpu.scales).abs() / cpu.scales).max().item()
    same = ~code_flips
    r_card = card.residuals.cpu().reshape(e.shape)[same & valid]
    r_cpu = cpu.residuals.reshape(e.shape)[same & valid]
    resid_flips = r_card != r_cpu
    if resid_flips.any():
        q = [(e[same & valid] - c.centroids.cpu()[codes[same & valid]]) / c.scales.cpu()
             for c, codes in ((card, c_card), (cpu, c_cpu))]
        apart = (q[0] - q[1]).abs()[resid_flips].max().item()
        check(apart < RESID_TIE, f"codec: a residual flip is no rounding near-tie ({apart})")
    return {"centroid_max_abs_err": cent_err, "scale_max_rel_err": scale_err,
            "code_flips": int(code_flips.sum()), "residual_flips": int(resid_flips.sum()),
            "valid_tokens": int(valid.sum())}


def compressed_retrieval(index, Qm, smi):
    """Phase 10a: ``index`` (phase 3's) compressed on the card, then
    CompressedSearcher over bench.py's 32 queries and phase 3's ``Qm``,
    against the exact K1 search and the plain two-stage version. Returns
    (the phase's line, K1's line at stage 1's launch shape, the 32 queries
    and their exact top-100)."""
    from reranking_multimodal_retrievers_tpu_torch.engine import make_search_fn
    from reranking_multimodal_retrievers_tpu_torch.engine.codec import compress, decompress
    from reranking_multimodal_retrievers_tpu_torch.engine.plaid import (
        CompressedSearcher, stage1_k1, stage1_plain, stage2_top_k)
    from reranking_multimodal_retrievers_tpu_torch.engine.search import SLAB_DOCS
    from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_cuda import maxsim_scores

    t0 = time.perf_counter()
    emb, mask = index.embeddings, index.mask
    N, LD, DIM = emb.shape
    Qb = torch.as_tensor(np.random.default_rng(1).normal(size=(PLAID_B, PLAID_LQ, DIM))
                         .astype(np.float32)).cuda()
    Qb16 = Qb.to(torch.bfloat16)
    exact = make_search_fn(N, k=PLAID_K)
    slabs = -(-N // SLAB_DOCS)

    reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cidx = compress(emb, mask, index.doc_ids, num_centroids=PLAID_CENTROIDS, device="cuda")
    torch.cuda.synchronize()
    compress_s = time.perf_counter() - t1
    searcher = CompressedSearcher(cidx, k=PLAID_K, n_candidates=PLAID_CANDIDATES)
    _, exact_ids = exact(Qb16, emb, mask)
    vals, ids = searcher.search(Qb)
    _, exact_ids_m = exact(Qm, emb, mask)
    vals_m, ids_m = searcher.search(Qm)
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches == {"K1": 4 * slabs, "K2": 0, "K3": 0, "K2f32": 0, "K2any": 0},
          f"compressed retrieval launches {launches}, want K1 = {4 * slabs} and no other")
    exact_ids, exact_ids_m = exact_ids.cpu().numpy(), exact_ids_m.cpu().numpy()
    check(ids.shape == (PLAID_B, PLAID_K) and bool(np.isfinite(vals).all())
          and bool(np.isfinite(vals_m).all()), f"compressed top-k {ids.shape}")
    bf16_bytes = N * LD * DIM * 2
    recall, recall_m = recall_at_k(ids, exact_ids), recall_at_k(ids_m, exact_ids_m)
    # a wrong codec or wrong ids would find about k / N of the exact top-k
    check(recall > 0.1 and recall_m > 0.1, f"compressed recall {recall}, {recall_m}")

    # checks: the top-100 against the plain two-stage version on the card,
    # stage 1 through K1 against the plain stage 1 on one slab, the codec
    # against the CPU on a subset
    t2 = time.perf_counter()
    arrays = (cidx.codes, cidx.residuals, cidx.centroids, cidx.scales, cidx.mask)
    with torch.inference_mode():
        plain1 = stage1_plain(Qb, *arrays, chunk=searcher.chunk, bf16=True)
        pv, pi = stage2_top_k(Qb, plain1, *arrays, PLAID_CANDIDATES, PLAID_K)
        del plain1
        top_err = same_top_k(vals, ids, pv.cpu().numpy(), pi.cpu().numpy(), PLAID_ATOL,
                             PLAID_RTOL)
        one = (cidx.codes[:SLAB_DOCS], cidx.residuals[:SLAB_DOCS], cidx.centroids,
               cidx.scales, cidx.mask[:SLAB_DOCS])
        s_k1 = stage1_k1(Qb, *one)
        s_plain = stage1_plain(Qb, *one, chunk=256, bf16=True)
        stage1_err = (s_k1 - s_plain).abs().max().item()
        check(torch.allclose(s_k1, s_plain, atol=PLAID_ATOL, rtol=PLAID_RTOL),
              f"stage 1 through K1 off the plain stage 1 by {stage1_err}")
        del s_k1, s_plain
    sub = slice(0, PLAID_SUBSET)
    sub_ids = index.doc_ids[sub]
    card_sub = compress(emb[sub], mask[sub], sub_ids, num_centroids=PLAID_CENTROIDS,
                        device="cuda")
    cpu_sub = compress(emb[sub].cpu(), mask[sub].cpu(), sub_ids,
                       num_centroids=PLAID_CENTROIDS, device="cpu")
    codec_check = compare_codecs(card_sub, cpu_sub, emb[sub])
    del card_sub, cpu_sub
    check_s = time.perf_counter() - t2

    # where the time goes (after the counts were read)
    with torch.inference_mode():
        plaid_ms = best_ms(lambda: searcher.search(Qb))
        exact_ms = best_ms(lambda: exact(Qb16, emb, mask)[1].cpu())
        stage1_ms = cuda_ms(lambda: stage1_k1(Qb, *arrays), 3)
        decompress_ms = cuda_ms(lambda: [decompress(cidx.codes[s:s + SLAB_DOCS],
                                                    cidx.residuals[s:s + SLAB_DOCS],
                                                    cidx.centroids, cidx.scales).to(torch.bfloat16)
                                         for s in range(0, N, SLAB_DOCS)], 3)
        stage1_kernel_ms = cuda_ms(lambda: [maxsim_scores(Qb16, emb[s:s + SLAB_DOCS],
                                                          mask[s:s + SLAB_DOCS])
                                            for s in range(0, N, SLAB_DOCS)], 3)
        stage1 = stage1_k1(Qb, *arrays)
        stage2_ms = cuda_ms(lambda: stage2_top_k(Qb, stage1, *arrays, PLAID_CANDIDATES,
                                                 PLAID_K), 3)
        del stage1
        D0 = decompress(cidx.codes[:SLAB_DOCS], cidx.residuals[:SLAB_DOCS], cidx.centroids,
                        cidx.scales).to(torch.bfloat16)
        k1 = k1_line(Qb16, D0, cidx.mask[:SLAB_DOCS].contiguous(),
                     "stage 1 of compressed search (10a)")
        del D0
    k1["launches"] = launches["K1"] - 2 * slabs  # the exact searches are phase 3's shape
    line = {"phase": "retrieve_compressed", "card": smi, "index": [N, LD, DIM],
            "queries": PLAID_B, "query_tokens": PLAID_LQ, "k": PLAID_K,
            "n_candidates": PLAID_CANDIDATES, "num_centroids": PLAID_CENTROIDS,
            "compress_seconds": compress_s, "compressed_bytes": cidx.nbytes(),
            "bf16_bytes": bf16_bytes, "memory_ratio": bf16_bytes / cidx.nbytes(),
            "search_ms": plaid_ms, "queries_per_s": PLAID_B / (plaid_ms * 1e-3),
            "exact_search_ms": exact_ms, "exact_queries_per_s": PLAID_B / (exact_ms * 1e-3),
            "stage1_ms": stage1_ms, "stage1_decompress_ms": decompress_ms,
            "stage1_k1_ms": stage1_kernel_ms, "stage2_ms": stage2_ms,
            "recall_at_100": recall, "flmr_queries_recall_at_100": recall_m,
            "top100_vs_plain_max_abs_err": top_err, "stage1_vs_plain_max_abs_err": stage1_err,
            "codec_card_vs_cpu": {"docs": PLAID_SUBSET, **codec_check},
            "check_seconds": check_s, "launches": launches,
            "seconds": time.perf_counter() - t0}
    del cidx, searcher
    gc.collect()
    torch.cuda.empty_cache()
    return line, k1, (Qb, exact_ids)


def pooled_retrieval(index, Qb, exact_ids, smi):
    """Phase 10b: ``index`` pooled 2x on the card, Searcher over it (K1 at
    L_d = 128), recall against 10a's exact top-100. Returns (the phase's
    line, K1's line at the pooled launch shape)."""
    from reranking_multimodal_retrievers_tpu_torch.engine import Searcher, pool_doc_tokens, pool_index
    from reranking_multimodal_retrievers_tpu_torch.engine.search import SLAB_DOCS

    t0 = time.perf_counter()
    N = index.num_padded_docs
    reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pooled = pool_index(index, factor=POOL_FACTOR, batch=POOL_BATCH)
    torch.cuda.synchronize()
    pool_s = time.perf_counter() - t1
    searcher = Searcher(pooled, k=PLAID_K)
    ids, vals = searcher.search(Qb)
    torch.cuda.synchronize()
    launches = read_counts()
    slabs = -(-N // SLAB_DOCS)
    check(launches == {"K1": slabs, "K2": 0, "K3": 0, "K2f32": 0, "K2any": 0},
          f"pooled retrieval launches {launches}, want K1 = {slabs} and no other")
    check(len(ids) == PLAID_B and all(len(r) == PLAID_K for r in ids)
          and bool(np.isfinite(vals).all()), "pooled top-k")
    # information: pooling random unit tokens keeps little of their ranking;
    # the kernel check below and the CPU check of the pooling hold the path
    recall = recall_at_k(ids, exact_ids)
    search_ms = best_ms(lambda: searcher.search(Qb))
    # one batch against the CPU
    n = POOL_CHECK_DOCS
    with torch.inference_mode():
        p_card, m_card = pool_doc_tokens(index.embeddings[:n], index.mask[:n], factor=POOL_FACTOR)
        p_cpu, m_cpu = pool_doc_tokens(index.embeddings[:n].cpu(), index.mask[:n].cpu(),
                                       factor=POOL_FACTOR)
    pool_err = (p_card.cpu().float() - p_cpu.float()).abs().max().item()
    check(torch.equal(m_card.cpu(), m_cpu) and pool_err <= 2.0 ** -8,
          f"pooled tokens on the card off the CPU's by {pool_err}")
    with torch.inference_mode():
        k1 = k1_line(Qb.to(torch.bfloat16), pooled.embeddings[:SLAB_DOCS],
                     pooled.mask[:SLAB_DOCS].contiguous(), "pooled index, L_d = 128 (10b)")
    k1["launches"] = launches["K1"]
    line = {"phase": "retrieve_pooled", "card": smi, "index": list(pooled.embeddings.shape),
            "factor": POOL_FACTOR, "pool_seconds": pool_s, "search_ms": search_ms,
            "queries_per_s": PLAID_B / (search_ms * 1e-3), "recall_at_100": recall,
            "pool_vs_cpu_max_abs_err": pool_err, "launches": launches,
            "seconds": time.perf_counter() - t0}
    del pooled, searcher
    gc.collect()
    torch.cuda.empty_cache()
    return line, k1


def baleen_tokenize(queries, passages, maxlen=BALEEN_MAXLEN, max_sents=32):
    """Whitespace tokenizer with the ``[MASK]``-separator convention (BERT's
    ids: [CLS] 101, [SEP] 102, [MASK] 103; other words hashed into
    1000-29999): ``[CLS] query [SEP] passage [SEP]``, padded to ``maxlen``;
    each ``[MASK]`` after the first [SEP] anchors a sentence."""
    import zlib

    B = len(passages)
    ids = np.zeros((B, maxlen), np.int64)
    am, tt = np.zeros_like(ids), np.zeros_like(ids)
    sp = np.full((B, max_sents), -1, np.int64)
    special = {"[CLS]": 101, "[SEP]": 102, "[MASK]": 103}
    for b, (q, p) in enumerate(zip(queries, passages)):
        qt = q.split()
        toks = (["[CLS]"] + qt + ["[SEP]"] + p.split() + ["[SEP]"])[:maxlen]
        sep_at = len(qt) + 1
        nsent = 0
        for i, t in enumerate(toks):
            ids[b, i] = special.get(t, 1000 + zlib.crc32(t.encode()) % 29000)
            if t == "[MASK]" and i > sep_at and nsent < max_sents:
                sp[b, nsent] = i
                nsent += 1
            am[b, i] = 1
            tt[b, i] = int(i > sep_at)
    return ids, am, tt, sp


def baleen(smi):
    """Phase 10c: two Baleen hops (25 then 10 passages) for 4 questions over
    a synthetic 4,096-passage collection, the readers at ELECTRA-large width
    in bf16 through K2. Returns (the phase's line, K2's line)."""
    import zlib

    from reranking_multimodal_retrievers_tpu_torch.engine import Searcher, TokenIndex
    from reranking_multimodal_retrievers_tpu_torch.engine.condenser import (
        BaleenEngine, Condenser, HopConfig, HopSearcher, SentenceReader)
    from reranking_multimodal_retrievers_tpu_torch.models import BertConfig

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 20)
    words = [f"w{i}" for i in range(20000)]

    def sentence(lo, hi):
        return " ".join(words[j] for j in rng.integers(0, len(words), int(rng.integers(lo, hi))))

    workdir = Path(__file__).resolve().parent / "build" / "chip_smoke_baleen"
    workdir.mkdir(parents=True, exist_ok=True)
    path = workdir / "collectionX.jsonl"
    with open(path, "w") as f:
        for pid in range(BALEEN_PASSAGES):
            f.write(json.dumps({"pid": pid, "title": sentence(2, 5),
                                "text": [sentence(8, 21) for _ in range(int(rng.integers(4, 9)))]})
                    + "\n")
    # ELECTRA-large: 24 layers, 1024 hidden, 16 heads x 64, 4096 FFN
    cfg = BertConfig(vocab_size=30522, hidden_size=1024, num_hidden_layers=24,
                     num_attention_heads=16, intermediate_size=4096,
                     max_position_embeddings=512, use_pallas_attention=True)
    readers = [SentenceReader(cfg, device="cuda", dtype=torch.bfloat16,
                              generator=torch.Generator(device="cuda").manual_seed(SEED + i)).eval()
               for i in (21, 22)]
    condenser = Condenser(str(path), readers[0], readers[1], readers[0], baleen_tokenize)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    index = TokenIndex(embeddings=unit(gen, BALEEN_PASSAGES, 128, 128),
                       mask=torch.ones(BALEEN_PASSAGES, 128, dtype=torch.bool, device="cuda"),
                       doc_ids=[str(p) for p in range(BALEEN_PASSAGES)])
    hops = HopSearcher(Searcher(index, k=HopConfig().ncandidates), HopConfig())

    def encode_query(text, facts):
        g = torch.Generator(device="cuda").manual_seed(
            zlib.crc32(" # ".join([text] + list(facts)).encode()))
        return unit(g, 1, BALEEN_QTOKENS, 128)

    engine = BaleenEngine(hops, condenser, encode_query, num_hops=2)
    questions = [f"which {sentence(3, 6)} is {sentence(2, 4)}" for _ in range(BALEEN_QUERIES)]
    setup_s = time.perf_counter() - t0
    engine.search(questions[0])  # warms up cuBLAS
    torch.cuda.synchronize()

    reset_counts()
    t1 = time.perf_counter()
    results = [engine.search(q) for q in questions]
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = read_counts()
    # per question and hop: one search (one slab) and two reader forwards
    # (stage 1, stage 2) of 24 layers each
    want = {"K1": 2 * BALEEN_QUERIES, "K2": 2 * 2 * cfg.num_hidden_layers * BALEEN_QUERIES,
            "K3": 0, "K2f32": 0, "K2any": 0}
    check(launches == want, f"Baleen launches {launches}, want {want}")
    for r in results:
        check(r["pids"] and all(p in condenser.collectionX for p in r["pids"])
              and all(k in condenser.collectionY for k in r["facts"])
              and len(r["pids"]) <= sum(HopConfig().per_hop_k), f"Baleen result {r}")

    # the first hop's stage-1 scores of four passages against fp32 on the CPU
    t2 = time.perf_counter()
    ranking, _ = hops.search(encode_query(questions[0], []), 0)
    passages = [" [MASK] ".join(condenser.collectionX[int(p)]) for p in ranking[0]]
    toks = baleen_tokenize([questions[0]] * len(passages), passages)
    card = condenser._score(readers[0], questions[0], passages[:4])
    cpu = SentenceReader(cfg, device="meta")
    cpu.load_state_dict({k: v.float().cpu() for k, v in readers[0].state_dict().items()},
                        assign=True)
    with torch.inference_mode():
        want_s = cpu(*(torch.as_tensor(a[:4]) for a in toks)).numpy()
    finite = np.isfinite(want_s)
    check((np.isfinite(card) == finite).all(), "Baleen: padded sentence slots differ")
    score_err = float(np.abs(card[finite] - want_s[finite]).max())
    check(np.allclose(card[finite], want_s[finite], atol=BALEEN_ATOL, rtol=BALEEN_RTOL),
          f"Baleen stage-1 scores {card[finite][:8]} vs CPU fp32 {want_s[finite][:8]}")
    cpu_s = time.perf_counter() - t2
    del cpu
    # K2 at the first hop's stage-1 launch shape, with its key mask
    keep = torch.as_tensor(toks[1], device="cuda").bool()
    k2 = _k2_interaction("key bias L=512, 16 heads (Baleen reader, 10c)", keep,
                         cfg.num_attention_heads, cfg.head_dim, gen, smi)
    k2["launches"] = launches["K2"]
    line = {"phase": "baleen", "card": smi, "passages": BALEEN_PASSAGES,
            "questions": BALEEN_QUERIES, "hops": 2, "per_hop_k": list(HopConfig().per_hop_k),
            "reader": "ELECTRA-large width (24 x 1024, 16 x 64 heads), bf16, K2",
            "seq_len": BALEEN_MAXLEN, "setup_seconds": setup_s, "run_seconds": run_s,
            "questions_per_s": BALEEN_QUERIES / run_s,
            "facts_per_question": [len(r["facts"]) for r in results],
            "stage1_vs_cpu_fp32_max_abs_err": score_err, "cpu_check_seconds": cpu_s,
            "launches": launches, "seconds": time.perf_counter() - t0}
    del readers, condenser, engine, index
    shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return line, k2


def triples_training(smi):
    """Phase 10d: the triples trainer (TriplesTrainerConfig's defaults) for
    10 steps on the card with a text-only FLMR at BERT-base width in fp32;
    the first step's loss against the CPU's, and one KL-distillation step
    card against CPU. Returns the phase's line."""
    import logging

    from reranking_multimodal_retrievers_tpu_torch.engine import trainer
    from reranking_multimodal_retrievers_tpu_torch.models import (
        BertConfig, FLMRConfig, FLMRModelForRetrieval)

    t0 = time.perf_counter()
    cfg = trainer.TriplesTrainerConfig()
    n_q = TRIPLES_STEPS * cfg.bsize
    queries = {i: f"question {i}" for i in range(n_q)}
    collection = [f"passage {i}" for i in range(4 * n_q)]
    rng = np.random.default_rng(SEED + 30)
    triples = [[q, *map(int, rng.integers(0, len(collection), cfg.nway))] for q in range(n_q)]
    scored = [[q] + [[int(p), float(rng.normal())]
                     for p in rng.integers(0, len(collection), cfg.nway)]
              for q in range(TRIPLES_KL_B)]
    fcfg = FLMRConfig(text_config=BertConfig(), dim=128, use_vision_encoder=False,
                      query_concat_output_from_vision_encoder=False,
                      use_transformer_mapping_network=False)
    state = {k: v.cpu() for k, v in FLMRModelForRetrieval(
        fcfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED + 31)
    ).state_dict().items()}

    def model_on(dev):
        m = FLMRModelForRetrieval(fcfg, device="meta")
        # a copy: training updates the weights in place
        m.load_state_dict({k: v.to(dev, copy=True) for k, v in state.items()}, assign=True)
        return m

    class Losses(logging.Handler):
        """Each logged step's loss (the trainer logs steps 1 and 10)."""

        def __init__(self):
            super().__init__()
            self.steps = {}

        def emit(self, record):
            self.steps[record.args[0]] = (record.args[1], record.created)

    log = logging.getLogger(trainer.__name__)
    seen = Losses()
    log.addHandler(seen)
    log.setLevel(logging.INFO)
    try:
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, ema = trainer.train(cfg, triples, queries, collection, model=model_on("cuda"),
                               device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        launches = read_counts()
        check(launches == {"K1": 0, "K2": 0, "K3": 0, "K2f32": 0, "K2any": 0},
              f"triples launches {launches}")
        check(sorted(seen.steps) == [1, TRIPLES_STEPS] and np.isfinite(ema),
              f"triples steps logged {sorted(seen.steps)}, ema {ema}")
        card_loss = seen.steps[1][0]
        steps_per_s = (TRIPLES_STEPS - 1) / (seen.steps[TRIPLES_STEPS][1] - seen.steps[1][1])
        # the KL path: one step on the card, its loss is the ema of one step
        kl_cfg = dataclasses.replace(cfg, bsize=TRIPLES_KL_B, maxsteps=1)
        _, kl_card = trainer.train(kl_cfg, scored, queries, collection, model=model_on("cuda"),
                                   device="cuda")
    finally:
        log.removeHandler(seen)
    t2 = time.perf_counter()
    _, cpu_loss = trainer.train(dataclasses.replace(cfg, maxsteps=1), triples, queries,
                                collection, model=model_on("cpu"), device="cpu")
    _, kl_cpu = trainer.train(kl_cfg, scored, queries, collection, model=model_on("cpu"),
                              device="cpu")
    cpu_s = time.perf_counter() - t2
    errs = (loss_rel_err(card_loss, cpu_loss), loss_rel_err(kl_card, kl_cpu))
    check(max(errs) <= TRAIN_LOSS_TOL,
          f"triples losses card {card_loss}, {kl_card} vs CPU {cpu_loss}, {kl_cpu}")
    return {"phase": "train_triples", "card": smi, "steps": TRIPLES_STEPS, "bsize": cfg.bsize,
            "nway": cfg.nway, "query_maxlen": cfg.query_maxlen, "doc_maxlen": cfg.doc_maxlen,
            "model": "text-only FLMR, BERT-base, dim 128, fp32 (TF32 off)",
            "first_loss": card_loss, "first_loss_cpu": cpu_loss, "kl_loss": kl_card,
            "kl_loss_cpu": kl_cpu, "loss_rel_err": list(errs), "loss_tol": TRAIN_LOSS_TOL,
            "ema_loss": ema, "run_seconds": run_s, "steps_per_s": steps_per_s,
            "cpu_check_seconds": cpu_s, "launches": launches,
            "seconds": time.perf_counter() - t0}


# ---- phase 11: the CLI (cli/main.py -> Experiment -> executors -> data
# pipeline -> metrics) at full width

CLI_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
CONFIGS = Path(__file__).resolve().parent / "configs"
FLMR_CONFIG, RERANK_CONFIG = "synth_flmr_fullsize.json", "synth_rerank_full_context_fullsize.json"
# 11a: one epoch cut to 20 steps; 11d: 10 steps; the first TIMED_FROM steps
# of a run are warm-up for its steps/s
CLI_FLMR_STEPS, CLI_RERANK_STEPS, TIMED_FROM = 20, 10, 5
# 11d's test: 50 batches of 4, 200 of the 500 queries (a cut for time)
CLI_RERANK_TEST_BATCHES = 50
# K2's fp32 path against its plain version, both fp32 with TF32 off: the JAX
# package's tolerance for the same comparison (tests/test_maxsim_pallas.py)
K2F32_RTOL, K2F32_ATOL = 1e-4, 2e-5
# H100 SXM peaks (data sheet): TF32 tensor cores, and fp32 outside them.
# K2's fp32 path does each product three times in TF32 (3xTF32); its bound
# is max(bytes / 3.35 TB/s, 3 * operations / 495 TFLOP/s), and the bound of
# the same operations in fp32 FFMA is printed beside it
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
# card fp32 against CPU fp32 (TF32 off for cuBLAS and cuDNN): round-off
# alone, as phase 8's TRAIN_LOSS_TOL; the rerank logits through 12 + 1
# layers and the mapping network, fp32 K2 on the card, the plain attention
# on the CPU: a share of max(1, |logit|)
CLI_LOSS_TOL, CLI_LOGIT_TOL = 1e-5, 1e-4


class _Recorder:
    """Wrappers, for the duration of a ``with`` block, around functions the
    executors call by name: they time them, keep their results or their
    first inputs per shape, and call the original (whose launch counter
    counts as it would)."""

    def __init__(self):
        self.undo = []

    def patch(self, obj, name, make):
        orig = getattr(obj, name)
        setattr(obj, name, make(orig))
        self.undo.append((obj, name, orig))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for obj, name, orig in reversed(self.undo):
            setattr(obj, name, orig)


def _clock(log):
    """A method wrapper that appends (seconds, result) of each call, after a
    synchronize."""
    def make(orig):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig(*args, **kwargs)
            torch.cuda.synchronize()
            log.append((time.perf_counter() - t, out))
            return out
        return timed
    return make


def _first_inputs(store, key_fn):
    """A function wrapper that keeps clones of the first call's arguments
    for each key ``key_fn(*args)`` gives (None: not kept), and counts the
    calls per key."""
    def make(orig):
        def keep(*args, **kwargs):
            key = key_fn(*args)
            if key is not None:
                entry = store.setdefault(key, {"calls": 0})
                entry["calls"] += 1
                if "args" not in entry:
                    entry["args"] = [a.clone() if isinstance(a, torch.Tensor) else a
                                     for a in args]
                    entry["kwargs"] = dict(kwargs)
            return orig(*args, **kwargs)
        return keep
    return make


def _k2_key(q, k, v, bias=None, *rest):
    return (tuple(q.shape), bias is not None) if q.dtype == torch.float32 and q.is_cuda else None


def _k2_bf16_key(q, k, v, bias=None, *rest):
    return (tuple(q.shape), bias is not None) if q.dtype == torch.bfloat16 and q.is_cuda else None


def k2_bf16_line(entry, name):
    """K2's bf16 key-bias path against its plain version on the first inputs
    a phase gave it at one launch shape (``k2_variant``), with the launches
    at that shape."""
    args, kw = entry["args"], entry["kwargs"]
    q, k, v = args[:3]
    bias = args[3] if len(args) > 3 else kw.get("mask_bias")
    check(bias is not None and len(args) <= 4 and not kw.get("causal", False)
          and kw.get("head_bias") is None, f"K2 {name}: not the key-bias variant")
    heads = kw["num_heads"]
    B, L, HD = q.shape
    row = k2_variant(name, q, k, v, bias, None, heads=heads, scale=kw["sm_scale"], causal=False,
                     sdpa_mask=(bias == 0)[:, None, None, :], flops=4 * B * L * L * HD)
    row["launches"] = entry["calls"]
    return row


def k2f32_bound(flops, nbytes):
    """(bound ms, what bounds it, fp32 FFMA bound ms) of K2's fp32 path: the
    3xTF32 products on the tensor cores against the bytes, and the same
    operations in fp32 FFMA (the bound before the tensor cores)."""
    b_ms, b_by = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
    ffma_ms, _ = bound(flops, nbytes, PEAK_FP32_FLOPS)
    return b_ms, b_by, ffma_ms


def k2f32_check(name, q, k, v, bias, head_bias=None, *, heads, scale, causal=False,
                sdpa_mask=None, flops=None, profile=True):
    """K2's fp32 path against its plain version on the card, timed beside
    the plain version and ``scaled_dot_product_attention`` in fp32 with
    ``sdpa_mask`` (in turns). ``flops``: the work the inputs need (4 B H L^2
    hd, about half under the causal mask)."""
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention, fused_self_attention_reference)

    kw = dict(num_heads=heads, sm_scale=scale, causal=causal)
    B, L, HD = q.shape
    got = fused_self_attention(q, k, v, bias, head_bias, **kw)
    ref = fused_self_attention_reference(q, k, v, bias, head_bias, **kw)
    err = (got - ref).abs().max().item()
    check(bool(torch.isfinite(got).all()) and torch.allclose(got, ref, rtol=K2F32_RTOL,
                                                             atol=K2F32_ATOL),
          f"fp32 K2 {name} at {[B, L, HD]}: max |diff| {err}")
    del got, ref
    qh, kh, vh = (x.view(B, L, heads, HD // heads).transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if flops is None:
        flops = 4 * B * heads * L * L * (HD // heads)
    nbytes = 4 * q.numel() * 4 + (0 if bias is None else bias.numel() * 4)
    if head_bias is not None:
        nbytes += head_bias.numel() * head_bias.element_size()
    b_ms, b_by, ffma_ms = k2f32_bound(flops, nbytes)
    kernel = lambda: fused_self_attention(q, k, v, bias, head_bias, **kw)  # noqa: E731
    library = lambda: sdpa(qh, kh, vh, attn_mask=sdpa_mask, scale=scale)  # noqa: E731
    times = k2_timed(kernel, library, flops, b_ms)
    if profile:  # the device's own times, beside the events' (costly: a trace each)
        (dev, dev_src), (lib, lib_src) = device_ms(kernel), device_ms(library)
        times.update(device_ms=dev, device_ms_source=dev_src, library_device_ms=lib,
                     library_device_ms_source=lib_src)
    return dict(variant=name, shape=[B, L, HD], heads=heads, head_dim=HD // heads,
                dtype=_k2_dtype(q), mask=_k2_mask(bias, head_bias, causal),
                max_abs_err=err, tol=[K2F32_RTOL, K2F32_ATOL],
                plain_ms=cuda_ms(lambda: fused_self_attention_reference(
                    q, k, v, bias, head_bias, **kw), 3),
                bound_ms=b_ms, bound_by=b_by, bound_ffma_ms=ffma_ms,
                share_of_bound_ffma=ffma_ms / times["ms"], flops=flops, **times)


def k2f32_line(entry, name):
    """K2's fp32 path against its plain version on the first inputs a phase
    gave it at one launch shape, whatever the variant (key bias, head bias,
    causal), with the library's call on the same mask (``k2f32_check``)."""
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import causal_bias

    args, kw = entry["args"], entry["kwargs"]
    q, k, v = args[:3]
    bias = args[3] if len(args) > 3 else kw.get("mask_bias")
    hb = args[4] if len(args) > 4 else kw.get("head_bias")
    causal = bool(kw.get("causal", False))
    heads = kw["num_heads"]
    B, L, HD = q.shape
    hd = HD // heads
    if hb is None and not causal:
        mask = None if bias is None else (bias == 0)[:, None, None, :]
    else:
        mask = torch.zeros(B, 1, L, L, device="cuda")
        if bias is not None:
            mask += bias[:, None, None, :]
        if hb is not None:
            mask = mask + hb.float()[None]
        if causal:
            mask += causal_bias(L, "cuda")
    pairs = L * (L + 1) // 2 if causal else L * L
    row = k2f32_check(name, q, k, v, bias, hb, heads=heads, scale=kw["sm_scale"],
                      causal=causal, sdpa_mask=mask, flops=4 * B * heads * pairs * hd)
    if hb is not None:
        row["max_abs_head_bias"] = hb.abs().max().item()
        if row["max_abs_head_bias"] < 1.0:
            row["head_bias_note"] = ("near zero at T5's init (relative-position tables at "
                                     "std d_model^-1/2): phase 2's check at scores of std 8 "
                                     "is the strong one")
    del mask
    return row


def k2f32_variants(gen, smi):
    """Phase 2's fp32 K2 rows for the options phase 11 does not take: an
    fp32 head bias at Flan-T5-XL's encoder shape (T5's sm_scale 1; timed at
    scores of order 1, also checked at scores of std 8) and the causal mask
    at OPT-2.7b's, with right-padded keys as the decoder rerankers pad."""
    rows = []
    for B, H, hd, causal in ((10, 32, 64, False), (5, 32, 80, True)):
        L = 544
        q, k, v = (torch.randn(B, L, H * hd, device="cuda", generator=gen) for _ in range(3))
        lens = torch.randint(L // 2, L + 1, (B,), device="cuda", generator=gen)
        keep = torch.arange(L, device="cuda")[None, :] < lens[:, None]
        bias = torch.where(keep, 0.0, -1e9)
        if causal:
            tri = torch.ones(L, L, dtype=torch.bool, device="cuda").tril()
            row = k2f32_check("causal, head_dim 80 at OPT-2.7b's [5, 544, 32x80] "
                              "(not on the main path)", q, k, v, bias, heads=H,
                              scale=hd ** -0.5, causal=True,
                              sdpa_mask=tri[None, None] & keep[:, None, None, :],
                              flops=4 * B * H * (L * (L + 1) // 2) * hd)
        else:
            hb = torch.randn(H, L, L, device="cuda", generator=gen)
            mask = bias[:, None, None, :] + hb[None]
            # T5's unscaled q: scores of std 8 (|s| up to ~40), held at the
            # same tolerance; both sides' distance from fp64 as information
            big = k2f32_fp64_errors(q, k, v, bias, hb, heads=H, scale=1.0)
            check(big["kernel_vs_plain_over_tol"] <= 0,
                  f"fp32 K2 head_bias at scores of std 8: {big}")
            row = k2f32_check("head_bias fp32 at Flan-T5-XL's [10, 544, 32x64] "
                              "(not on the main path)", q * 0.125, k, v, bias, hb, heads=H,
                              scale=1.0, sdpa_mask=mask)
            row["scores_std_8"] = big
            del hb, mask
        row["launches"] = 0  # phase 11, the main path, takes neither option
        emit({"phase": "kernel_check", "kernel": "K2 fused_self_attention fp32", "card": smi,
              **row})
        rows.append(row)
        del q, k, v
    return rows


# Phase 2's K2 rows at the head widths beyond 64 and 80 (the _narrow and
# _wide libraries of csrc/attention.cu and attention_f32.cu): (heads,
# head_dim, batch, L, variant); bf16 at the BERT-like [100, 512] shapes and the T5/OPT-like
# [10|5, 512] ones, fp32 at the CLI's [64, 32] and at [16, 512]
K2_WIDTHS_BF16 = [
    (24, 32, 100, 512, "key"), (6, 128, 100, 512, "key"), (8, 16, 8, 512, "key"),
    (8, 48, 100, 512, "key"), (8, 96, 100, 512, "key"), (8, 112, 100, 512, "key"),
    (24, 32, 10, 512, "head"), (6, 128, 10, 512, "head"),
    (24, 32, 5, 512, "causal"), (6, 128, 5, 512, "causal")]
K2_WIDTHS_F32 = [
    (4, 32, 64, 32, "key"), (8, 16, 64, 32, "key"), (8, 48, 64, 32, "key"),
    (4, 96, 64, 32, "key"), (4, 112, 64, 32, "key"), (2, 128, 64, 32, "key"),
    (24, 32, 16, 512, "key"), (6, 128, 16, 512, "key"),
    (24, 32, 10, 512, "head"), (6, 128, 10, 512, "head"),
    (24, 32, 5, 512, "causal"), (6, 128, 5, 512, "causal")]


def k2_library(hd, fp32):
    """The library (``ops/_build.py::SOURCES``) of K2's kernel at head
    width ``hd``: a per-width instance, or the generic kernel."""
    from reranking_multimodal_retrievers_tpu_torch.ops import attention_cuda

    return attention_cuda.kernel_library(hd, fp32)


def k2_source(hd, fp32):
    """The source in the repo of K2's instance at head width ``hd``."""
    from reranking_multimodal_retrievers_tpu_torch.ops import _build

    return ("reranking_multimodal_retrievers_tpu_torch/csrc/"
            + _build.SOURCES[k2_library(hd, fp32)])


def _k2_where(row):
    """(dtype, shape, heads, mask) of a K2 row, or None where it has none."""
    if not all(key in row for key in ("dtype", "shape", "heads", "mask")):
        return None
    return row["dtype"], tuple(row["shape"]), row["heads"], row["mask"]


def k2_width_launches(widths, path_rows):
    """Each head-width row's ``launches``: the main path's launches at its
    dtype, shape, heads and mask, summed from the per-shape counts the
    main path's phases recorded in this run (``path_rows``, each checked
    against its phase's launch count); and ``launches_at_head_dim``: the
    same at its dtype, head_dim and mask whatever the shape (the same
    compiled instance)."""
    def instance(where):
        dtype, shape, heads, mask = where
        return dtype, shape[-1] // heads, mask

    recorded = [(_k2_where(r), r["launches"]) for r in path_rows if _k2_where(r) is not None]
    for row in widths:
        where = _k2_where(row)
        row["launches"] = sum(n for w, n in recorded if w == where)
        row["launches_at_head_dim"] = sum(n for w, n in recorded
                                          if instance(w) == instance(where))


# Phase 2's K2 rows at the head geometries the JAX gate admits outside the
# per-width kernels (C9 in ROADMAP.md), all on csrc/attention_any.cu, in bf16 and
# fp32: (heads, head_dim, batch, L, variant). No configuration of the repo
# reaches them (ViT-G's 16 x 104 is in the ViT, which fuses in neither
# package), so their main-path launches are 0.
K2_C9 = [
    (16, 8, 100, 512, "key"), (16, 24, 100, 512, "key"), (16, 40, 100, 512, "key"),
    (16, 104, 100, 512, "key"), (32, 12, 100, 512, "key"), (2, 256, 16, 512, "key"),
    (2, 192, 16, 512, "key"), (1, 384, 8, 512, "key"),
    (16, 24, 10, 512, "head"), (16, 24, 5, 512, "causal"),
    (2, 256, 16, 512, "head"), (2, 256, 16, 512, "causal"),
    # an odd width (2-byte copies in bf16) and a width whose rows are summed
    # in two chunks over two column blocks
    (128, 3, 8, 512, "key"), (16, 136, 100, 512, "key")]
# each K2_C9 row's ms on the FFMA kernel that attention_any.cu replaced, from
# this script's phase 2 on an NVIDIA H100 80GB HBM3 at 700.00 W, bf16 then
# fp32; the rows added since have none
K2_C9_EARLIER_MS = {
    (dtype, *geometry): ms
    for dtype, times in (("bf16", (3.953, 4.818, 6.296, 25.88, 8.512, 0.903, 0.621, 0.479, 0.573,
                                   0.256, 0.988, 0.894)),
                         ("fp32", (4.013, 4.801, 6.290, 26.54, 8.444, 1.018, 0.820, 0.460, 0.636,
                                   0.257, 1.105, 1.049)))
    for geometry, ms in zip(K2_C9, times)}


def k2_width_rows(gen, smi, tables=None, kernel_name="K2 fused_self_attention, head widths",
                  profile=True, earlier=None):
    """K2 bf16 and fp32 at the head widths the port took on beside 64 and
    80 (or at ``tables``' (bf16 rows, fp32 rows)), each against its plain
    version (bf16 within K2_TOL, fp32 within K2F32_RTOL/K2F32_ATOL), timed
    beside its plain version and ``scaled_dot_product_attention`` on the
    same mask, with its bound; key bias (right-padded keys), bf16 or fp32
    head bias with the key bias, and the causal mask with the key bias.
    ``earlier``: an earlier kernel's ms by (dtype, heads, head_dim, batch,
    L, variant), printed beside each row's. Their launches on the main path
    are filled in after it ran (:func:`k2_width_launches`)."""
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import causal_bias

    rows = []
    for fp32, table in zip((False, True), tables or (K2_WIDTHS_BF16, K2_WIDTHS_F32)):
        dtype = torch.float32 if fp32 else torch.bfloat16
        for heads, hd, B, L, variant in table:
            q, k, v = (torch.randn(B, L, heads * hd, device="cuda", generator=gen).to(dtype)
                       for _ in range(3))
            lens = torch.randint(L // 2, L + 1, (B,), device="cuda", generator=gen)
            keep = torch.arange(L, device="cuda")[None, :] < lens[:, None]
            bias = torch.where(keep, 0.0, -1e9)
            hb, causal, pairs = None, variant == "causal", L * L
            if variant == "key":
                mask = keep[:, None, None, :]
            elif variant == "head":
                hb = torch.randn(heads, L, L, device="cuda", generator=gen).to(dtype)
                mask = (bias[:, None, None, :] + hb.float()[None]).to(dtype)
            else:
                pairs = L * (L + 1) // 2
                mask = (causal_bias(L, "cuda")[None, None] == 0) & keep[:, None, None, :]
            what = {"key": "key bias", "head": "head bias and key bias",
                    "causal": "causal and key bias"}[variant]
            name = (f"{'fp32 ' if fp32 else ''}{what}, head_dim {hd} at "
                    f"[{B}, {L}, {heads}x{hd}] (phase 2)")
            flops = 4 * B * heads * pairs * hd
            if fp32:
                row = k2f32_check(name, q, k, v, bias, hb, heads=heads, scale=hd ** -0.5,
                                  causal=causal, sdpa_mask=mask, flops=flops, profile=profile)
            else:
                row = k2_variant(name, q, k, v, bias, hb, heads=heads, scale=hd ** -0.5,
                                 causal=causal, sdpa_mask=mask, flops=flops)
            row.update(head_dim=hd, library=k2_library(hd, fp32), source=k2_source(hd, fp32))
            line = {"phase": "kernel_check", "kernel": kernel_name, "card": smi, **row}
            if earlier is not None:  # this line only: the kernels line keeps this run's numbers
                was = earlier.get((row["dtype"], heads, hd, B, L, variant))
                line.update(earlier_ms=was, x_earlier=None if was is None else row["ms"] / was)
            emit(line)
            rows.append(row)
            del q, k, v, hb, mask
    return rows


def k2f32_fp64_errors(q, k, v, bias, head_bias, *, heads, scale, causal=False):
    """Max |error| of K2's fp32 path and of its plain version (fp32, TF32
    off) against the same function in fp64 on the card, of the one against
    the other, and by how much the largest of the latter exceeds
    ``K2F32_ATOL + K2F32_RTOL * |plain|`` (<= 0: within)."""
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        causal_bias, fused_self_attention, fused_self_attention_reference)

    kw = dict(num_heads=heads, sm_scale=scale, causal=causal)
    got = fused_self_attention(q, k, v, bias, head_bias, **kw)
    ref = fused_self_attention_reference(q, k, v, bias, head_bias, **kw)
    B, L, HD = q.shape
    qh, kh, vh = (x.double().view(B, L, heads, HD // heads) for x in (q, k, v))
    sc = torch.einsum("bqnd,bknd->bnqk", qh, kh) * scale
    if bias is not None:
        sc += bias.double()[:, None, None, :]
    if head_bias is not None:
        sc += head_bias.double()[None]
    if causal:
        sc += causal_bias(L, q.device).double()
    exact = torch.einsum("bnqk,bknd->bqnd", torch.softmax(sc, -1), vh).reshape(B, L, HD)
    del sc
    over = ((got - ref).abs() - K2F32_ATOL - K2F32_RTOL * ref.abs()).max().item()
    return {"kernel_vs_fp64": (got.double() - exact).abs().max().item(),
            "plain_fp32_vs_fp64": (ref.double() - exact).abs().max().item(),
            "kernel_vs_plain": (got - ref).abs().max().item(),
            "kernel_vs_plain_over_tol": over}


def library_kernels(fn, reps=1):
    """The device kernels ``reps`` calls of ``fn`` run, with their device
    time in us and their count, from ``torch.profiler`` (empty if the
    profiler sees no device)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        if str(getattr(e, "device_type", "")).endswith("CUDA") and us > 0:
            out.append({"name": e.key, "us": us, "count": e.count})
    return out


def device_ms(fn, reps=10):
    """(device time of ``fn``'s kernels a call, its source): at small shapes
    the time between launches (the host) sets ``cuda_ms``, this the card's
    own. From ``torch.profiler`` when it saw each kernel ``reps`` times (it
    can miss events), else from ``graph_ms`` (the kernels plus the gaps
    between them); (None, None) if neither works."""
    kernels = library_kernels(fn, reps)
    if kernels and all(k["count"] == reps for k in kernels):
        return sum(k["us"] for k in kernels) / reps / 1e3, "profiler"
    ms = graph_ms(fn, reps)
    return ms, None if ms is None else "cuda_graph"


def graph_ms(fn, reps=10):
    """ms a call of ``fn`` from one CUDA graph of ``reps`` calls replayed
    between two events, no host time between the launches; None if ``fn``
    cannot be captured."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        del graph
        return start.elapsed_time(end) / reps
    except RuntimeError:
        torch.cuda.synchronize()
        return None


def sass_counts(name):
    """Instruction counts of the built library ``name`` from ``cuobjdump
    -sass``: TF32 and bf16 tensor-core products, cp.async copies, fp32
    FFMA."""
    import os
    import re

    from reranking_multimodal_retrievers_tpu_torch.ops import _build

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    check(tool is not None, "cuobjdump not found")
    text = subprocess.run([tool, "-sass", str(_build._target(name))], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    ops = re.findall(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", text, re.M)
    return {"instructions": len(ops),
            "HMMA_TF32": sum(op.startswith("HMMA") and "TF32" in op for op in ops),
            "HMMA_BF16": sum(op.startswith("HMMA") and "BF16" in op for op in ops),
            "LDGSTS": sum(op.startswith("LDGSTS") for op in ops),
            "FFMA": sum(op.startswith("FFMA") for op in ops)}


def k3_line(Qq, qs, Dq, ds, M, name):
    """K3 against its plain version on the first inputs a phase gave it,
    timed beside it, with the bound of the same work."""
    from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_int8_cuda import (
        maxsim_scores_int8, maxsim_scores_int8_reference)

    B, LQ, DIM = Qq.shape
    N, LD, _ = Dq.shape
    got = maxsim_scores_int8(Qq, qs, Dq, ds, M)
    ref = maxsim_scores_int8_reference(Qq, qs, Dq, ds, M)
    err = (got - ref).abs().max().item()
    check(err <= K3_TOL, f"K3 {name}: max |diff| {err} > {K3_TOL}")
    ops = 2 * B * LQ * N * LD * DIM
    b_ms, b_by = bound(ops, Qq.numel() + qs.numel() * 4 + Dq.numel() + ds.numel() * 4
                       + (0 if M is None else M.numel()) + B * N * 4, PEAK_INT8_OPS)
    ms = cuda_ms(lambda: maxsim_scores_int8(Qq, qs, Dq, ds, M), 10)
    return dict(variant=name, shape=[[B, LQ, DIM], [N, LD, DIM]], max_abs_err=err, tol=K3_TOL,
                ms=ms, plain_ms=cuda_ms(lambda: maxsim_scores_int8_reference(Qq, qs, Dq, ds, M),
                                        1),
                bound_ms=b_ms, bound_by=b_by, library_ms=None, share_of_bound=b_ms / ms,
                tops=ops / (ms * 1e-3) / 1e12)


def _cli_opts():
    """--opts that put every path of both full-size configs under CLI_DIR and
    give the FLMR run the reranker config's synthetic data (visual key in
    the tail, its vocab and images): one dataset, generated once."""
    with open(CONFIGS / RERANK_CONFIG) as f:
        gen = dict(json.load(f)["data_pipeline"]["transforms"]["input:GenerateSynthetic"]
                   ["setup_kwargs"])
    gen.update(vocab_path=str(CLI_DIR / "vocab" / "vocab.txt"), images_dir=str(CLI_DIR / "images"))
    tok = "data_pipeline.transforms.output:PrepareDataloaders.setup_kwargs.tokenizer_config"
    return [f"meta.EXPERIMENT_FOLDER='{CLI_DIR / 'experiments'}'",
            f"data_pipeline.cache_dir='{CLI_DIR / 'cache'}'",
            f"data_pipeline.transforms.input:GenerateSynthetic.setup_kwargs={gen!r}",
            f"{tok}.tokenizer.TokenizerModelVersion='{CLI_DIR / 'vocab'}'",
            f"{tok}.decoder_tokenizer.TokenizerModelVersion='{CLI_DIR / 'vocab'}'",
            "train.trainer_paras.max_epochs=1", "train.trainer_paras.log_every_n_steps=1",
            "valid.trainer_paras.limit_val_batches=0"]


def _cli(config, mode, *opts):
    from reranking_multimodal_retrievers_tpu_torch.cli.main import main as cli_main

    rc = cli_main(["--config", str(CONFIGS / config), "--mode", mode, "--opts", *_cli_opts(),
                   *opts])
    check(rc == 0, f"cli {config} --mode {mode}: exit {rc}")


def _cpu_executor(cls, config, mode, *opts):
    """The executor of ``config`` on the CPU (its weights from the same seed,
    drawn on the CPU as on the card), over the cached dataset."""
    from reranking_multimodal_retrievers_tpu_torch.utils.config_system import (
        apply_opts, load_config)

    cfg = load_config(str(CONFIGS / config))
    apply_opts(cfg, [*_cli_opts(), f"meta.experiment_dir='{CLI_DIR / 'cpu_check'}'", *opts])
    cfg.set_path("mode", mode)
    return cls(cfg, device="cpu")


def _steps_per_s(log):
    times = np.cumsum([t for t, _ in log])
    return (len(times) - TIMED_FROM) / (times[-1] - times[TIMED_FROM - 1])


def _metrics_lines(exp_dir):
    with open(Path(exp_dir) / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _dump(exp_dir):
    with open(Path(exp_dir) / "test_predictions_rank_0.json") as f:
        return json.load(f)


def cli_phases(smi):
    """Phase 11. Returns (lines, kernel rows, launch counts of each part)."""
    import os

    from reranking_multimodal_retrievers_tpu_torch.engine import search as search_mod
    from reranking_multimodal_retrievers_tpu_torch.engine.rerank_eval import (
        make_chunked_rerank_fn)
    from reranking_multimodal_retrievers_tpu_torch.executors import (FLMRExecutor,
                                                                     RerankerExecutor)
    from reranking_multimodal_retrievers_tpu_torch.models import bert as bert_mod
    from reranking_multimodal_retrievers_tpu_torch.models.tokenization import (
        remove_instruction_prefix)

    lines, parts = [], {}
    os.environ.pop("RMRT_PLATFORM", None)  # the CLI runs on the card
    if CLI_DIR.exists():
        shutil.rmtree(CLI_DIR)
    def exp_dir(config):  # the first run of the config's experiment
        with open(CONFIGS / config) as f:
            return CLI_DIR / "experiments" / json.load(f)["meta"]["experiment_name"] / "version_0"

    flmr_dir, rr_dir = exp_dir(FLMR_CONFIG), exp_dir(RERANK_CONFIG)
    # CLI_DIR stays for phase 12, which removes it
    try:
        # -- 11a. FLMR train
        t0 = time.perf_counter()
        steps = []
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with _Recorder() as rec:
            rec.patch(FLMRExecutor, "training_step", _clock(steps))
            _cli(FLMR_CONFIG, "train", f"train.trainer_paras.limit_train_batches={CLI_FLMR_STEPS}")
        parts["11a"] = read_counts()
        check(sum(parts["11a"].values()) == 0, f"11a training launched kernels: {parts['11a']}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        wall = time.perf_counter() - t0
        check(len(steps) == CLI_FLMR_STEPS, f"11a took {len(steps)} steps")
        card = [m for m in _metrics_lines(flmr_dir) if m.get("step") == 1 and "ib_loss" in m][0]
        t1 = time.perf_counter()
        cpu_ex = _cpu_executor(FLMRExecutor, FLMR_CONFIG, "train")
        with torch.no_grad():
            out = cpu_ex.model(**cpu_ex.model_batch(next(iter(cpu_ex.train_dataloader()))),
                               num_negative_examples=cpu_ex.num_negative_samples)
        cpu = {"loss": float(out.loss), "ib_loss": float(out.in_batch_negative_loss)}
        del cpu_ex, out
        loss_err = max(abs(card[k] - v) / max(1.0, abs(v)) for k, v in cpu.items())
        check(loss_err <= CLI_LOSS_TOL, f"11a first step: card {card} vs CPU fp32 {cpu}")
        lines.append({"phase": "cli_flmr_train", "config": FLMR_CONFIG, "steps": len(steps),
                      "batch": 32, "steps_per_s": _steps_per_s(steps),
                      "examples_per_s": 32 * _steps_per_s(steps), "peak_memory_gb": peak_gb,
                      "first_step_card": {k: card[k] for k in cpu}, "first_step_cpu_fp32": cpu,
                      "first_step_rel_err": loss_err, "tol": CLI_LOSS_TOL,
                      "cpu_check_seconds": time.perf_counter() - t1,
                      "launches": parts["11a"], "wall_seconds": wall, "card": smi,
                      "seconds": time.perf_counter() - t0})

        # -- 11b. FLMR test: K1 over the bf16 index, fp32 K2 in the encoders
        def flmr_test(name, *opts):
            t0 = time.perf_counter()
            idx_log, q_log, s_log, k1_in, k3_in, k2_in = [], [], [], {}, {}, {}
            reset_counts()
            with _Recorder() as rec:
                rec.patch(FLMRExecutor, "build_index", _clock(idx_log))
                rec.patch(FLMRExecutor, "encode_queries", _clock(q_log))
                rec.patch(search_mod.Searcher, "search", _clock(s_log))
                rec.patch(search_mod, "maxsim_scores",
                          _first_inputs(k1_in, lambda Q, D, M=None, *r: tuple(Q.shape)))
                rec.patch(search_mod, "maxsim_scores_int8",
                          _first_inputs(k3_in, lambda Qq, *r: tuple(Qq.shape)))
                rec.patch(bert_mod, "fused_self_attention", _first_inputs(k2_in, _k2_key))
                _cli(FLMR_CONFIG, "test", f"meta.experiment_dir='{flmr_dir}'",
                     "model_config.flmr.text_config.use_pallas_attention=true", *opts)
            torch.cuda.synchronize()
            launches = read_counts()
            wall = time.perf_counter() - t0
            dump = _dump(flmr_dir)
            preds = dump["predictions"]
            check(len(preds) == 500 and all(len(p["top_ranking_passages"]) == 100
                                            and np.isfinite([d["score"] for d in
                                                             p["top_ranking_passages"]]).all()
                                            for p in preds), f"{name}: the prediction dump")
            index = idx_log[0][1]
            n_q = sum(int(q.shape[0]) for _, q in q_log)
            index_s = sum(t for t, _ in idx_log)
            encode_s, search_s = sum(t for t, _ in q_log), sum(t for t, _ in s_log)
            m = dump["metrics"]
            line = {"phase": name, "docs": index.num_docs, "queries": len(preds),
                    "corpus_docs_per_s": index.num_docs / index_s, "index_seconds": index_s,
                    "queries_per_s": len(preds) / (encode_s + search_s), "encoded_queries": n_q,
                    "query_encode_seconds": encode_s, "search_seconds": search_s,
                    "recall_at_5": m["recall_at_5"], "recall_at_100": m["recall_at_100"],
                    "pos_item_ids_recall_at_5": m["pos_item_ids_recall_at_5"],
                    "pos_item_ids_recall_at_100": m["pos_item_ids_recall_at_100"],
                    "launches": launches, "wall_seconds": wall, "card": smi}
            return line, index, q_log, k1_in, k3_in, k2_in, dump

        t0 = time.perf_counter()
        line, index, q_log, k1_in, _, k2_in, dump_b = flmr_test("cli_flmr_test")
        parts["11b"] = line["launches"]
        check(parts["11b"]["K1"] > 0 and parts["11b"]["K2f32"] > 0 and parts["11b"]["K3"] == 0
              and parts["11b"]["K2"] == 0, f"11b launches {parts['11b']}")
        (k1_key, k1_entry), = k1_in.items()
        Qk1, Dk1, Mk1 = k1_entry["args"][:3]
        k1_row = k1_line(Qk1, Dk1, Mk1, "CLI test (11b)")
        # the first 8 queries' top-100 against the plain search over the index
        Q8 = q_log[0][1][:8].to(torch.bfloat16)
        worst = top_k_vs_plain(Q8, index, [p["top_ranking_passages"]
                                           for p in dump_b["predictions"][:8]])
        check(worst <= K1_TOL, f"11b top-100 off the plain search by {worst}")
        k2_rows = {key: k2f32_line(entry, f"{'x'.join(map(str, key[0]))} (11b, 11c)")
                   for key, entry in k2_in.items()}
        line.update(top100_vs_plain_max_abs_err=worst, top100_tol=K1_TOL,
                    k2f32_shapes={"x".join(map(str, key[0])): e["calls"]
                                  for key, e in k2_in.items()},
                    seconds=time.perf_counter() - t0)
        lines.append(line)
        shutil.copy(flmr_dir / "test_predictions_rank_0.json", CLI_DIR / "flmr_dump.json")
        del index, q_log, k1_in, Q8, Qk1, Dk1, Mk1, k1_entry

        # -- 11c. the same test over an int8 index (K3)
        t0 = time.perf_counter()
        line, index, _, _, k3_in, k2_in_c, dump_c = flmr_test(
            "cli_flmr_test_int8", "model_config.modules=['use_int8_index']")
        parts["11c"] = line["launches"]
        check(parts["11c"]["K3"] > 0 and parts["11c"]["K1"] == 0 and parts["11c"]["K2f32"] > 0,
              f"11c launches {parts['11c']}")
        (k3_key, k3_entry), = k3_in.items()
        k3_row = k3_line(*k3_entry["args"][:5], "CLI int8 test (11c)")
        overlap = float(np.mean([
            len({p["passage_id"] for p in a["top_ranking_passages"]}
                & {p["passage_id"] for p in b["top_ranking_passages"]}) / 100
            for a, b in zip(dump_b["predictions"], dump_c["predictions"])]))
        line.update(top100_overlap_with_bf16=overlap, seconds=time.perf_counter() - t0)
        lines.append(line)
        for key, row in k2_rows.items():  # 11c launches K2 at 11b's shapes again
            row["launches"] = k2_in[key]["calls"] + k2_in_c.get(key, {"calls": 0})["calls"]
        check(sum(r["launches"] for r in k2_rows.values())
              == parts["11b"]["K2f32"] + parts["11c"]["K2f32"],
              "11b/11c: fp32 K2 launches at shapes other than 11b's")
        del index, k3_in, k3_entry, dump_c, k2_in, k2_in_c

        # -- 11d. reranker train, then test over 11b's dump
        t0 = time.perf_counter()
        steps = []
        rr_opts = [f"model_config.retrieve_result_path='{CLI_DIR / 'flmr_dump.json'}'"]
        reset_counts()
        with _Recorder() as rec:
            rec.patch(RerankerExecutor, "training_step", _clock(steps))
            _cli(RERANK_CONFIG, "train", *rr_opts,
                 f"train.trainer_paras.limit_train_batches={CLI_RERANK_STEPS}")
        parts["11d_train"] = read_counts()
        check(sum(parts["11d_train"].values()) == 0,
              f"11d training launched kernels: {parts['11d_train']}")
        check(len(steps) == CLI_RERANK_STEPS, f"11d took {len(steps)} steps")
        train_line = {"steps": len(steps), "steps_per_s": _steps_per_s(steps),
                      "launches": parts["11d_train"], "seconds": time.perf_counter() - t0}

        t0 = time.perf_counter()
        k2_in, evals = {}, []
        reset_counts()
        with _Recorder() as rec:
            rec.patch(RerankerExecutor, "evaluate", _clock(evals))
            rec.patch(bert_mod, "fused_self_attention", _first_inputs(k2_in, _k2_key))
            _cli(RERANK_CONFIG, "test", *rr_opts, f"meta.experiment_dir='{rr_dir}'",
                 "model_config.cross_encoder.use_pallas_attention=true",
                 f"test.trainer_paras.limit_test_batches={CLI_RERANK_TEST_BATCHES}")
        torch.cuda.synchronize()
        parts["11d_test"] = read_counts()
        check(parts["11d_test"]["K2f32"] > 0 and parts["11d_test"]["K2"] == 0,
              f"11d test launches {parts['11d_test']}")
        dump = _dump(rr_dir)
        preds = dump["predictions"]
        check(len(preds) == 4 * CLI_RERANK_TEST_BATCHES
              and not any(p.get("static_retrieval_missing") for p in preds)
              and all(len(p["top_ranking_passages"]) == 100 for p in preds),
              "11d: the rerank dump")
        # four logits against the CPU: the checkpoint's weights in fp32
        t1 = time.perf_counter()
        cpu_ex = _cpu_executor(RerankerExecutor, RERANK_CONFIG, "test", *rr_opts,
                               f"meta.experiment_dir='{rr_dir}'")
        cpu_ex.load_checkpoint(cpu_ex.ckpt_manager.resolve())
        batch = next(iter(next(iter(cpu_ex.eval_dataloaders("test").values()))))
        docs = cpu_ex.static_retrieve(batch["question_ids"][0])[:4]
        mb = cpu_ex._build_rerank_inputs(
            {k: (v[:1] if k == "pixel_values" else v) for k, v in batch.items()},
            [remove_instruction_prefix(batch["questions"][0])], [d["content"] for d in docs], 4)
        want = make_chunked_rerank_fn(cpu_ex.reranker, nway=4, chunk_size=4)(
            mb["input_ids"], mb["attention_mask"], mb["token_type_ids"],
            mb["query_pixel_values"])[0].numpy()
        got_scores = {p["passage_id"]: p["score"] for p in preds[0]["top_ranking_passages"]}
        got = np.array([got_scores[d["passage_id"]] for d in docs])
        logit_err = float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))
        check(logit_err <= CLI_LOGIT_TOL, f"11d logits {got} vs CPU fp32 {want}")
        del cpu_ex
        m = dump["metrics"]
        eval_s = evals[0][0]
        rr_rows = {key: dict(k2f32_line(entry, f"{'x'.join(map(str, key[0]))} (11d)"),
                             launches=entry["calls"]) for key, entry in k2_in.items()}
        lines.append({"phase": "cli_rerank", "config": RERANK_CONFIG, "train": train_line,
                      "queries": len(preds), "candidates": 100 * len(preds),
                      "candidates_per_s": 100 * len(preds) / eval_s, "evaluate_seconds": eval_s,
                      "logits_vs_cpu_fp32": {"card": got.tolist(), "cpu": want.tolist(),
                                             "rel_err": logit_err, "tol": CLI_LOGIT_TOL},
                      "cpu_check_seconds": time.perf_counter() - t1,
                      **{k: m[k] for k in ("recall_at_5", "raw_recall_at_5",
                                           "pos_item_ids_recall_at_5",
                                           "pos_item_ids_raw_recall_at_5")},
                      "k2f32_shapes": {"x".join(map(str, key[0])): e["calls"]
                                       for key, e in k2_in.items()},
                      "launches": parts["11d_test"], "card": smi,
                      "seconds": time.perf_counter() - t0})
    except BaseException:
        if CLI_DIR.exists():
            shutil.rmtree(CLI_DIR)
        raise

    k1_row["launches"] = parts["11b"]["K1"]
    k3_row["launches"] = parts["11c"]["K3"]
    # K2's fp32 rows: one a launch shape, on the first inputs there, with
    # the launches at that shape
    return lines, k1_row, k3_row, list(k2_rows.values()) + list(rr_rows.values()), parts


# ---- phase 12: the interaction, fusion and decoder rerankers and RAG from
# cli.main at full width, over phase 11's dataset, 11a's FLMR checkpoint and
# 11b's dump

P12_DIR = CLI_DIR / "p12"
# 12a, 12b: 10 training steps, then 32 test queries x 100 candidates (of
# the 500 test queries: a cut for time)
P12_STEPS, P12_QUERIES, P12_TEST_BATCH = 10, 32, 8
# 12c, 12d, 12e: 8 test queries (x 100 candidates, x 5 docs for RAG)
P12_DEC_QUERIES, P12_DEC_STEPS, P12_RAG_STEPS = 8, 5, 3
# greedy decoding: tokens are compared up to the first step whose top-2
# logit gap on the kernel path is under this (past it either token is fp32's)
NEAR_TIE = 1e-5
# ModPreFLMR-BERT's cross-encoder (bench.py:187-242): 3 BERT-base layers
MODPREFLMR_CE = {"num_hidden_layers": 3, "max_position_embeddings": 512}
RETRIEVED = ["train_with_retrieved_docs", "neg_sample_retrieved"]


def _without_kernel(cfg):
    """A model config (nested dataclasses) with every
    ``use_pallas_attention`` off."""
    changes = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "use_pallas_attention" and v:
            changes[f.name] = False
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            changes[f.name] = _without_kernel(v)
    return dataclasses.replace(cfg, **changes)


def _plain_twin(model, dtype=None):
    """``model``'s class over its config without the kernel: the same
    weights through the plain attention, sharing its tensors, or copies in
    ``dtype``."""
    twin = type(model)(_without_kernel(model.config), device="meta")
    state = model.state_dict()
    if dtype is not None:
        state = {k: v.to(dtype) for k, v in state.items()}
    twin.load_state_dict(state, assign=True)
    return twin.eval()


def _keep_self(store):
    """A method wrapper that appends (seconds, the object it was called on)
    after a synchronize: the executor a CLI run made."""
    def make(orig):
        def kept(self, *args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig(self, *args, **kwargs)
            torch.cuda.synchronize()
            store.append((time.perf_counter() - t, self))
            return out
        return kept
    return make


def _one_query(batch, docs, n=4):
    """The first query of a collated batch with its first ``n`` docs."""
    rows = len(batch["question_ids"])
    one = {k: (v[:1] if hasattr(v, "__len__") and not isinstance(v, str) and len(v) == rows
               else v) for k, v in batch.items()}
    return one, [d["content"] for d in docs[:n]]


def _first_candidates(ex, n=4):
    """(first test query's batch, its first n docs, their model inputs)."""
    from reranking_multimodal_retrievers_tpu_torch.models.tokenization import (
        remove_instruction_prefix)

    batch = next(iter(next(iter(ex.eval_dataloaders("test").values()))))
    docs = ex.static_retrieve(batch["question_ids"][0])[:n]
    one, contents = _one_query(batch, docs, n)
    mb = ex._build_rerank_inputs(one, [remove_instruction_prefix(batch["questions"][0])],
                                 contents, n)
    return batch, docs, mb


def _rerank_logits(ex, mb, n=4):
    with torch.inference_mode():
        return ex.reranker(**mb, num_negative_examples=n - 1).logits.reshape(-1).float().cpu()


def _plain_logits(ex, n=4):
    """The first test query's first ``n`` candidates through the executor's
    models without the kernel (its frozen retriever too), on the card."""
    saved = ex.reranker, ex.retriever
    ex.reranker = _plain_twin(ex.reranker)
    if ex.retriever is not None:
        ex.retriever = _plain_twin(ex.retriever)
    try:
        _, docs, mb = _first_candidates(ex, n)
        return docs, _rerank_logits(ex, mb, n)
    finally:
        ex.reranker, ex.retriever = saved


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def p12_run(name, mode, exp, opts, want_launch=True, k2_stores=None):
    """One CLI run of phase 12 in experiment dir ``exp``: the launch counts
    (reset just before, read just after), the executor it made, the
    timed calls, peak memory and wall seconds. Training must launch
    nothing; a test run with ``want_launch`` must launch fp32 K2 and no
    other kernel."""
    from reranking_multimodal_retrievers_tpu_torch.executors import (RagExecutor,
                                                                     RerankerExecutor)
    from reranking_multimodal_retrievers_tpu_torch.models import bert as bert_mod
    from reranking_multimodal_retrievers_tpu_torch.models import opt as opt_mod
    from reranking_multimodal_retrievers_tpu_torch.models import t5 as t5_mod
    from reranking_multimodal_retrievers_tpu_torch.training.checkpointing import (
        CheckpointManager)

    rag = any("RagExecutor" in o for o in opts)
    cls = RagExecutor if rag else RerankerExecutor
    steps, evals, saves, loads = [], [], [], []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_counts()
    with _Recorder() as rec:
        rec.patch(cls, "training_step", _clock(steps))
        rec.patch(cls, "evaluate", _keep_self(evals))
        rec.patch(CheckpointManager, "save", _clock(saves))
        rec.patch(cls, "load_checkpoint", _clock(loads))
        for mod, tag in ((bert_mod, "bert"), (t5_mod, "t5"), (opt_mod, "opt")):
            if k2_stores is not None:
                rec.patch(mod, "fused_self_attention",
                          _first_inputs(k2_stores.setdefault(tag, {}), _k2_key))
        _cli(RERANK_CONFIG, mode, f"meta.experiment_dir='{exp}'", *opts)
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    if mode == "train":
        check(sum(launches.values()) == 0, f"{name} training launched kernels: {launches}")
    elif want_launch:
        check(launches["K2f32"] > 0 and launches["K1"] == launches["K2"] == launches["K3"] == 0,
              f"{name} test launches {launches}")
    line = {"phase": name, "mode": mode, "launches": launches, "wall_seconds": wall,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if steps:
        t = [dt for dt, _ in steps]
        line.update(steps=len(t), step_seconds=t,
                    steps_per_s=(len(t) - 1) / sum(t[1:]) if len(t) > 1 else 1 / t[0])
    if saves:
        line.update(checkpoint_save_seconds=sum(dt for dt, _ in saves),
                    checkpoint_gb=_dir_bytes(Path(exp) / "ckpts") / 1e9)
    if loads:
        line["checkpoint_load_seconds"] = sum(dt for dt, _ in loads)
    ex = evals[-1][1] if evals else None
    if evals:
        line["evaluate_seconds"] = evals[-1][0]
    return line, ex


def _k2_rows(stores, part, launch_total):
    """One kernels-line row per fp32 K2 launch shape a part met, checked on
    the first inputs there, with the launches at that shape; they must sum
    to the part's launch count."""
    rows = []
    for tag, store in stores.items():
        for (shape, _), entry in store.items():
            variant = {"bert": "key bias", "t5": "head_bias (T5 encoder)",
                       "opt": "causal (OPT)"}[tag]
            row = k2f32_line(entry, f"{variant} {'x'.join(map(str, shape))} ({part})")
            row["launches"] = entry["calls"]
            rows.append(row)
    check(sum(r["launches"] for r in rows) == launch_total,
          f"{part}: fp32 K2 launches at shapes not recorded")
    return rows


def _cpu_logits(opts, exp, docs):
    """The first test query's candidates ``docs`` through the checkpoint's
    weights on the CPU in fp32 (``_cpu_executor``)."""
    from reranking_multimodal_retrievers_tpu_torch.executors import RerankerExecutor
    from reranking_multimodal_retrievers_tpu_torch.models.tokenization import (
        remove_instruction_prefix)

    cpu_ex = _cpu_executor(RerankerExecutor, RERANK_CONFIG, "test", *opts,
                           f"meta.experiment_dir='{exp}'")
    cpu_ex.load_checkpoint(cpu_ex.ckpt_manager.resolve())
    batch = next(iter(next(iter(cpu_ex.eval_dataloaders("test").values()))))
    one, contents = _one_query(batch, docs, len(docs))
    mb = cpu_ex._build_rerank_inputs(one, [remove_instruction_prefix(batch["questions"][0])],
                                     contents, len(docs))
    out = _rerank_logits(cpu_ex, mb, len(docs))
    del cpu_ex
    return out


def p12_encoder_family(name, train_opts, test_opts, smi):
    """12a/12b: train P12_STEPS steps, test P12_QUERIES x 100 over 11b's
    dump with fp32 K2 in the encoders; four candidates' logits against the
    same models without the kernel on the card and against the
    checkpoint's weights on the CPU. Returns (line, K2 rows, launches)."""
    exp = P12_DIR / name
    train, _ = p12_run(f"{name}_train", "train", exp, [
        *train_opts, f"train.trainer_paras.limit_train_batches={P12_STEPS}"])
    stores = {}
    test, ex = p12_run(f"{name}_test", "test", exp, [
        *test_opts, f"test.batch_size={P12_TEST_BATCH}",
        f"test.trainer_paras.limit_test_batches={P12_QUERIES // P12_TEST_BATCH}"],
        k2_stores=stores)
    preds = _dump(exp)["predictions"]
    check(len(preds) == P12_QUERIES and all(
        len(p["top_ranking_passages"]) == 100 and not p.get("static_retrieval_missing")
        and np.isfinite([d["score"] for d in p["top_ranking_passages"]]).all()
        for p in preds), f"{name}: the rerank dump")
    scores = {d["passage_id"]: d["score"] for d in preds[0]["top_ranking_passages"]}
    docs, plain = _plain_logits(ex)
    got = np.array([scores[d["passage_id"]] for d in docs])
    plain_err = _rel_err(got, plain)
    check(plain_err <= CLI_LOGIT_TOL, f"{name}: logits {got} vs the plain path {plain}")
    del ex
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    cpu = _cpu_logits(test_opts, exp, docs)
    cpu_err = _rel_err(got, cpu)
    check(cpu_err <= CLI_LOGIT_TOL, f"{name}: logits {got} vs CPU fp32 {cpu}")
    m = _dump(exp)["metrics"]
    rows = _k2_rows(stores, name, test["launches"]["K2f32"])
    test.update(queries=len(preds), candidates=100 * len(preds),
                candidates_per_s=100 * len(preds) / test["evaluate_seconds"],
                logits_vs_plain={"card": got.tolist(), "plain": plain.tolist(),
                                 "rel_err": plain_err, "tol": CLI_LOGIT_TOL},
                logits_vs_cpu_fp32={"cpu": cpu.tolist(), "rel_err": cpu_err,
                                    "tol": CLI_LOGIT_TOL},
                cpu_check_seconds=time.perf_counter() - t1,
                k2f32_shapes={r["variant"]: r["launches"] for r in rows},
                **{k: m[k] for k in ("recall_at_5", "raw_recall_at_5", "pos_item_ids_recall_at_5",
                                     "pos_item_ids_raw_recall_at_5")})
    return {"phase": name, "card": smi, "train": train, "test": test}, rows


def _decoder_dict(backbone, text_config, yes_no, pallas):
    tc = dict(dataclasses.asdict(text_config), use_pallas_attention=pallas)
    return {"backbone": backbone, "text_config": tc, "num_query_tokens": 32,
            "yes_token_id": yes_no[0], "no_token_id": yes_no[1]}


def p12_decoder(name, backbone, text_config, yes_no, head, train_steps, dump, smi):
    """12c/12d: the decoder branch at full width. ``train_steps`` steps
    (vision frozen) unless 0, then P12_DEC_QUERIES x 100 with K2's fp32
    path in the language model; four candidates' scores against the same
    model without the kernel on the card."""
    exp = P12_DIR / name
    mods = ["decoder_reranker", *RETRIEVED, "freeze_reranker_vision_encoder"]
    common = [dump, f"model_config.modules={mods!r}", f"model_config.decoder_head={head}",
              "model_config.num_negative_samples=2",
              "train.optimizer_config.scheduler_params.num_warmup_steps=0"]
    lines = {}
    if train_steps:
        lines["train"], _ = p12_run(f"{name}_train", "train", exp, [
            *common, f"model_config.decoder={_decoder_dict(backbone, text_config, yes_no, False)!r}",
            "train.batch_size=2", f"train.trainer_paras.limit_train_batches={train_steps}"])
        losses = [r["loss"] for r in _metrics_lines(exp) if "loss" in r]
        check(len(losses) == train_steps and np.isfinite(losses).all(), f"{name} losses {losses}")
        lines["train"]["losses"] = losses
    stores = {}
    test, ex = p12_run(f"{name}_test", "test", exp, [
        *common, f"model_config.decoder={_decoder_dict(backbone, text_config, yes_no, True)!r}",
        f"test.batch_size={P12_DEC_QUERIES}", "test.trainer_paras.limit_test_batches=1"],
        k2_stores=stores)
    if train_steps:
        check("checkpoint_load_seconds" in test, f"{name}: the test loaded no checkpoint")
    preds = _dump(exp)["predictions"]
    check(len(preds) == P12_DEC_QUERIES and all(
        len(p["top_ranking_passages"]) == 100 and not p.get("static_retrieval_missing")
        and np.isfinite([d["score"] for d in p["top_ranking_passages"]]).all()
        for p in preds), f"{name}: the rerank dump")
    scores = {d["passage_id"]: d["score"] for d in preds[0]["top_ranking_passages"]}
    docs, plain = _plain_logits(ex)
    got = np.array([scores[d["passage_id"]] for d in docs])
    err = _rel_err(got, plain)
    check(err <= CLI_LOGIT_TOL, f"{name}: scores {got} vs the plain path {plain}")
    n_params = sum(p.numel() for p in ex.reranker.parameters())
    del ex
    gc.collect()
    torch.cuda.empty_cache()
    rows = _k2_rows(stores, name, test["launches"]["K2f32"])
    test.update(queries=len(preds), candidates=100 * len(preds),
                candidates_per_s=100 * len(preds) / test["evaluate_seconds"],
                scores_vs_plain={"card": got.tolist(), "plain": plain.tolist(), "rel_err": err,
                                 "tol": CLI_LOGIT_TOL},
                k2f32_shapes={r["variant"]: r["launches"] for r in rows})
    shutil.rmtree(exp / "ckpts", ignore_errors=True)
    return {"phase": name, "card": smi, "params": n_params, **lines, "test": test}, rows


def _greedy_with_gaps(ex, ids, am, pix):
    """The executor's generate_with_losses, with each greedy step's top-2
    logit gap [rows, steps]."""
    steps = []
    orig = ex._decode_logits

    def record(*args):
        out = orig(*args)
        steps.append(out)
        return out

    ex._decode_logits = record
    try:
        tokens, losses = ex.generate_with_losses(ids, am, pix)
    finally:
        ex._decode_logits = orig
    L = ex.max_answer_length
    gaps = torch.stack([torch.topk(s[:, t].float(), 2).values.diff(dim=-1).abs()[:, 0]
                        for t, s in enumerate(steps[:L])], dim=1).cpu().numpy()
    return tokens, losses, gaps


def p12_rag(text_config, dump, smi):
    """12e: RAG with the BLIP-2 Flan-T5-XL generator: P12_RAG_STEPS
    RAG-sequence steps (vision frozen), then per-doc greedy generation for
    P12_DEC_QUERIES queries x 5 docs with K2's fp32 path in the T5 encoder;
    the first query's per-doc tokens (up to near-ties) and losses against
    the same model without the kernel on the card."""
    name = "p12e_rag_blip2_flan_t5_xl"
    exp = P12_DIR / name
    dec = {"backbone": "blip2", "text_config": dataclasses.asdict(text_config),
           "num_query_tokens": 32}
    common = [dump, "executor.ExecutorClass='RagExecutor'",
              "metrics=[{'name': 'compute_exact_match'}, {'name': 'compute_okvqa_scores'}]",
              "model_config.modules=['rag_generation', 'freeze_reranker_vision_encoder']",
              "model_config.rag_num_docs=3", "model_config.docs_to_rerank=5",
              "model_config.max_answer_length=8", "model_config.max_source_length=64",
              "model_config.Ks=[1, 5]",
              "train.optimizer_config.scheduler_params.num_warmup_steps=0"]
    train, _ = p12_run(f"{name}_train", "train", exp, [
        *common, f"model_config.decoder={dec!r}", "train.batch_size=2",
        f"train.trainer_paras.limit_train_batches={P12_RAG_STEPS}"])
    losses = [r["loss"] for r in _metrics_lines(exp) if "loss" in r]
    check(len(losses) == P12_RAG_STEPS and np.isfinite(losses).all(), f"{name} losses {losses}")
    train["losses"] = losses
    dec["text_config"]["use_pallas_attention"] = True
    stores = {}
    test, ex = p12_run(f"{name}_test", "test", exp, [
        *common, f"model_config.decoder={dec!r}", f"test.batch_size={P12_DEC_QUERIES}",
        "test.trainer_paras.limit_test_batches=1"], k2_stores=stores)
    check("checkpoint_load_seconds" in test, f"{name}: the test loaded no checkpoint")
    dump = _dump(exp)
    preds = dump["predictions"]
    check(len(preds) == P12_DEC_QUERIES and "exact_match_at_1" in dump["metrics"]
          and all(len(p["per_doc_predictions"]) == len(p["loss_with_doc_scores"]) == 5
                  and np.isfinite(p["loss_with_doc_scores"]).all() for p in preds),
          f"{name}: the generation dump")
    # the first query's docs, with and without the kernel
    tok = ex.tokenizers["decoder_tokenizer"].tok
    batch = next(iter(next(iter(ex.eval_dataloaders("test").values()))))
    prompts = [f"question: {batch['questions'][0]} context: {d['content']}"
               for d in ex.static_retrieve(batch["question_ids"][0])[:5]]
    enc = tok(prompts, padding="max_length", truncation=True, max_length=ex.max_source_length,
              return_tensors="np")
    ids = torch.as_tensor(enc["input_ids"]).long().cuda()
    am = torch.as_tensor(enc["attention_mask"]).long().cuda()
    pix = torch.as_tensor(np.asarray(batch["pixel_values"])[:1]).float().cuda()
    tokens, k_losses, gaps = _greedy_with_gaps(ex, ids, am, pix)
    check([tok.decode(t, skip_special_tokens=True) for t in tokens]
          == preds[0]["per_doc_predictions"], f"{name}: the dump's first query")
    lm = ex.lm
    ex.lm = _plain_twin(lm)
    try:
        p_tokens, p_losses = ex.generate_with_losses(ids, am, pix)
    finally:
        ex.lm = lm
    n_params = sum(p.numel() for p in lm.parameters())
    del ex, lm
    gc.collect()
    torch.cuda.empty_cache()
    ties, compared = [], 0
    for r in range(tokens.shape[0]):
        low = np.nonzero(gaps[r] < NEAR_TIE)[0]
        upto = int(low[0]) + 1 if len(low) else tokens.shape[1]
        ties.append(None if not len(low) else int(low[0]))
        check(np.array_equal(tokens[r, :upto], p_tokens[r, :upto]),
              f"{name}: doc {r} tokens {tokens[r]} vs the plain path {p_tokens[r]}")
        if not len(low):
            compared += 1
            err = _rel_err(k_losses[r], p_losses[r])
            check(err <= CLI_LOGIT_TOL, f"{name}: doc {r} loss {k_losses[r]} vs {p_losses[r]}")
    rows = _k2_rows(stores, name, test["launches"]["K2f32"])
    answers = P12_DEC_QUERIES * 5
    test.update(queries=len(preds), generated_answers=answers,
                answers_per_s=answers / test["evaluate_seconds"],
                first_query={"tokens_equal_up_to_near_ties": True, "near_tie_step": ties,
                             "losses": np.asarray(k_losses).tolist(),
                             "plain_losses": np.asarray(p_losses).tolist(),
                             "losses_compared": compared, "tol": CLI_LOGIT_TOL,
                             "min_top2_gap": float(gaps.min())},
                k2f32_shapes={r["variant"]: r["launches"] for r in rows},
                **{k: v for k, v in dump["metrics"].items() if k.startswith("exact_match")})
    shutil.rmtree(exp / "ckpts", ignore_errors=True)
    return {"phase": name, "card": smi, "params": n_params, "train": train, "test": test}, rows


def p12_phases(smi):
    """Phase 12, after phase 11 (its dataset, 11a's checkpoint and 11b's
    dump under CLI_DIR); prints each part's line as it ends. Returns (K2
    rows, launch counts of each CLI run)."""
    from reranking_multimodal_retrievers_tpu_torch.models import OPTConfig, T5Config

    ckpts = CLI_DIR / "experiments" / "synth_flmr_fullsize" / "version_0" / "ckpts"
    with open(ckpts / "index.json") as f:
        flmr_ckpt = ckpts / json.load(f)["last"]
    with open(CONFIGS / FLMR_CONFIG) as f:
        dim = json.load(f)["model_config"]["flmr"]["dim"]
    dump = f"model_config.retrieve_result_path='{CLI_DIR / 'flmr_dump.json'}'"
    retriever = f"model_config.retriever_model_path='{flmr_ckpt}'"
    pallas = "model_config.flmr.text_config.use_pallas_attention=true"
    rows, parts = [], {}

    def done(line, r):
        emit(line)
        rows.extend(r)
        for mode in ("train", "test"):
            if mode in line:
                parts[f"{line['phase']}_{mode}"] = line[mode]["launches"]

    # 12a: the interaction rerankers over the frozen 11a retriever
    for itype in ("MORES", "CrossEncoder"):
        ce = dict(MODPREFLMR_CE, use_pallas_attention=itype == "CrossEncoder")
        base = [dump, retriever, f"model_config.interaction_type='{itype}'",
                f"model_config.late_interaction_dim={dim}",
                f"model_config.modules={['interaction_reranker', *RETRIEVED]!r}"]
        done(*p12_encoder_family(
            f"p12a_interaction_{itype.lower()}",
            [*base, f"model_config.cross_encoder={MODPREFLMR_CE!r}"],
            [*base, f"model_config.cross_encoder={ce!r}", pallas], smi))
    # 12b: the spliced reranker warm-started from 11a, biased by 11a's scores
    base = [dump, retriever, f"model_config.reranker_backbone_path='{flmr_ckpt}'",
            f"model_config.modules={[*RETRIEVED, 'preflmr_attention_fusion']!r}"]
    done(*p12_encoder_family("p12b_fusion", base, [*base, pallas], smi))
    # 12c: monoBLIP2-Flan-T5-XL, 12d: monoBLIP2-Opt-2.7b (head model)
    t5 = T5Config.flan_t5_xl()
    t_host = time.perf_counter()
    torch.empty(250_000_000).normal_(0.0, 0.02, generator=torch.Generator().manual_seed(SEED))
    host_draw_s = (time.perf_counter() - t_host) / 0.25  # a billion weights
    line, r = p12_decoder("p12c_blip2_flan_t5_xl", "blip2", t5, T5_YES_NO, False,
                          P12_DEC_STEPS, dump, smi)
    line["host_draw_seconds_per_1e9_weights"] = host_draw_s
    done(line, r)
    done(*p12_decoder("p12d_blip2_opt_2_7b_head", "blip2_opt", OPTConfig.opt_2_7b(),
                      OPT_YES_NO, True, 0, dump, smi))
    # 12e: RAG with the BLIP-2 Flan-T5-XL generator
    done(*p12_rag(t5, dump, smi))
    return rows, parts


# ---- phase 13: real-format M2KR data (save_to_disk directories, baseline
# JPEG) and cli.main --mode prepare_data through the captioner, ViT features
# and the live distillation teacher, then FLMR train and test over it

P13_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_p13"
FIXTURE_JPEG = Path(__file__).resolve().parent / "tests" / "fixtures" / "baseline_420_rst.jpg"
# 13a: M2KR-shaped data: questions, the passage corpus (phase 11's size),
# distinct images (PNGs of photograph-like sizes, plus the committed JPEG)
P13_TRAIN, P13_TEST, P13_PASSAGES, P13_IMAGES, P13_WORDS = 2048, 512, 30_000, 256, 2000
# 13b: rows of each split prepared (LoadPreprocessedData's num_data; a cut
# for time), the teacher's negatives, the ViT rows held against the CPU (a
# cut of its first batch of 16, for time)
P13_NUM_DATA, P13_NEGATIVES, P13_VIT_CPU_ROWS = 32, 4, 4
# 13b's models: the captioner (bench.py:260-390's BLIP-2 Flan-T5-XL), CLIP
# ViT-L/14 at 224, and the teacher at configs/synth_flmr_fullsize.json's
# widths (BERT-base, ViT-B/32, dim 128)
P13_VIT = {"hidden_size": 1024, "intermediate_size": 4096, "num_hidden_layers": 24,
           "num_attention_heads": 16, "image_size": 224, "patch_size": 14}
# 13c: configs/evqa_flmr.json's pipeline over 13a's directories: 10 train
# steps and 8 test batches of 16, 128 of the 512 queries (a cut for time)
P13_STEPS, P13C_TEST_BATCHES = 10, 8


def _p13_captioner_config():
    """BLIP-2 Flan-T5-XL (ViT-g, the BERT-base Q-Former, 32 query tokens,
    Flan-T5-XL) with ``use_pallas_attention`` in the T5 config."""
    from reranking_multimodal_retrievers_tpu_torch.models.blip2 import Blip2Config
    from reranking_multimodal_retrievers_tpu_torch.models.t5 import T5Config

    return Blip2Config(text_config=T5Config.flan_t5_xl(use_pallas_attention=True))


_P13_SYLL = ["ka", "lo", "mi", "ne", "ru", "sa", "ti", "vo", "ze", "po", "da", "fu", "gi", "ho"]
# 13b's captioner prompt: the T5 encoder then runs 32 query tokens + 16
P13_PROMPT = "a photo of"
P13_PROMPT_TOKENS = 16  # blip2_greedy_captions pads the prompt to 16 tokens
P13_VOCAB = 32_100  # Flan-T5's tokenizer: 32,000 pieces and 100 sentinels
P13_TOK_TEXTS = 2048  # texts encoded and id rows decoded for the host rates


def _p13_words(n):
    """``n`` distinct lower-case pseudo-words (the text of 13a's rows)."""
    out = []
    for i in range(n):
        w, j = "", i
        while True:
            w += _P13_SYLL[j % len(_P13_SYLL)]
            j //= len(_P13_SYLL)
            if not j:
                break
        out.append(w + "x")
    return out


def _p13_tokenizer(words):
    """A full-size synthetic Flan-T5 tokenizer directory: a Unigram model
    of 32,100 pieces as Flan-T5's (``<pad>``, ``</s>``, ``<unk>``, then
    the prompt's words, the metaspace, characters, 13a's pseudo-words and
    their syllables as ``▁``-pieces and bare, more pseudo-words to the
    count, then ``<extra_id_99..0>``), scores on a 1/4 grid from the seed
    (the prompt's words best, so that each is one piece), and a charsmap of
    full-width forms, the ideographic space, a combining sequence and a
    ligature. Returns (its path, the pieces)."""
    import string

    from reranking_multimodal_retrievers_tpu_torch.models.tokenization import (
        write_precompiled_charsmap, write_unigram_tokenizer)

    rng = np.random.default_rng(SEED + 13)
    n = P13_VOCAB - 3 - 100
    head = (["▁" + w for w in P13_PROMPT.split()] + ["▁"]
            + list(string.ascii_lowercase + string.digits + string.punctuation)
            + ["▁" + s for s in _P13_SYLL] + _P13_SYLL + ["▁" + w for w in words])
    pieces = list(dict.fromkeys(head))
    seen = set(pieces)
    for w in _p13_words(n):
        for p in ("▁" + w, w):
            if len(pieces) < n and p not in seen:
                pieces.append(p)
                seen.add(p)
    check(len(pieces) == n, f"13b: {len(pieces)} tokenizer pieces")
    k = len(P13_PROMPT.split())
    scores = [-1.0] * k + (-rng.integers(12, 80, n - k) / 4.0).tolist()
    charsmap = {**{chr(0xFF01 + i): chr(0x21 + i) for i in range(94)}, "　": " ",
                "é": "é", "ﬁ": "fi"}
    path = write_unigram_tokenizer(str(P13_DIR / "flan_t5_tokenizer"), pieces, scores,
                                   write_precompiled_charsmap(charsmap))
    return path, pieces


def _p13_tokenizer_rates(path, words):
    """The tokenizer's host rates: a fresh load, then ``P13_TOK_TEXTS``
    question-like texts (13a's words, some full-width or combining) encoded
    as the captioner encodes a prompt, padded to 32, and as many id rows of
    20 (a caption's length) decoded."""
    from reranking_multimodal_retrievers_tpu_torch.models.tokenization import UnigramTokenizer

    rng = np.random.default_rng(SEED + 14)
    texts = []
    for i in range(P13_TOK_TEXTS):
        t = " ".join(words[j] for j in rng.integers(0, len(words), int(rng.integers(6, 16))))
        texts.append(t.replace("a", "ａ", 1) if i % 4 == 1 else
                     t.replace("e", "é", 1) if i % 4 == 2 else t)
    t0 = time.perf_counter()
    tok = UnigramTokenizer.from_pretrained(path)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc = tok(texts, padding="max_length", truncation=True, max_length=32, return_tensors="np")
    enc_s = time.perf_counter() - t0
    rows = rng.integers(3, P13_VOCAB - 100, (P13_TOK_TEXTS, 20))
    t0 = time.perf_counter()
    out = tok.batch_decode(rows, skip_special_tokens=True)
    dec_s = time.perf_counter() - t0
    check(len(out) == len(texts) and all(out), "13b: the tokenizer's decodes")
    return {"pieces": len(tok), "load_seconds": load_s, "texts": len(texts),
            "encode_seconds": enc_s, "encodes_per_s": len(texts) / enc_s,
            "encode_tokens_per_s": int(enc["attention_mask"].sum()) / enc_s,
            "decode_seconds": dec_s, "decodes_per_s": len(rows) / dec_s,
            "decode_tokens_per_s": rows.size / dec_s,
            "note": "host clock, one pass each from a fresh load (its word cache cold)"}


def _p13_spiece_route(words):
    """The captioner's tokenizer built from a directory holding only the
    ``spiece.model`` written from the committed Unigram fixture
    (``models/spiece.py``), against the ``tokenizer.json`` route on the
    same fixture: equal ids and masks on 13b's texts (13a's words, some
    full-width or combining), padded to 32; its encodes/s."""
    from reranking_multimodal_retrievers_tpu_torch.data.ops.infoseek_ops import (
        load_caption_tokenizer)
    from reranking_multimodal_retrievers_tpu_torch.models.spiece import (
        spiece_from_tokenizer_json)

    rng = np.random.default_rng(SEED + 15)
    texts = []
    for i in range(P13_TOK_TEXTS):
        t = " ".join(words[j] for j in rng.integers(0, len(words), int(rng.integers(6, 16))))
        texts.append(t.replace("a", "ａ", 1) if i % 4 == 1 else
                     t.replace("e", "é", 1) if i % 4 == 2 else t)
    only = P13_DIR / "spiece_only"
    only.mkdir(parents=True, exist_ok=True)
    with open(P13D_TOKENIZER / "tokenizer.json", encoding="utf-8") as f:
        spiece_from_tokenizer_json(json.load(f), str(only / "spiece.model"))
    check(sorted(p.name for p in only.iterdir()) == ["spiece.model"], "13b: the spiece directory")
    t0 = time.perf_counter()
    tok = load_caption_tokenizer(str(only))
    load_s = time.perf_counter() - t0
    want = load_caption_tokenizer(str(P13D_TOKENIZER))
    t0 = time.perf_counter()
    got = tok(texts, padding="max_length", truncation=True, max_length=32, return_tensors="np")
    enc_s = time.perf_counter() - t0
    ref = want(texts, padding="max_length", truncation=True, max_length=32, return_tensors="np")
    check(np.array_equal(got["input_ids"], ref["input_ids"])
          and np.array_equal(got["attention_mask"], ref["attention_mask"]),
          "13b: the spiece.model tokenizer's ids or masks differ from tokenizer.json's")
    return {"texts": len(texts), "pieces": len(tok), "load_seconds": load_s,
            "encode_seconds": enc_s, "encodes_per_s": len(texts) / enc_s,
            "ids_and_masks_equal_tokenizer_json": True,
            "note": "host clock, one pass from a fresh load"}


def _p13_image(rng, h, w):
    """A photograph-like RGB image: smooth colour fields in 8 x 8 blocks."""
    small = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3), dtype=np.uint8)
    return np.ascontiguousarray(np.repeat(np.repeat(small, 8, 0), 8, 1)[:h, :w])


def p13_real_format_data(smi):
    """13a. Writes the M2KR-shaped ``save_to_disk`` directories with the
    port's own writer, reads them back and checks every column. Returns
    (the line, the vocabulary's words)."""
    import os

    from reranking_multimodal_retrievers_tpu_torch.data import arrow_io
    from reranking_multimodal_retrievers_tpu_torch.data.image_io import read_image, write_png
    from reranking_multimodal_retrievers_tpu_torch.data.table import Table

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    words = _p13_words(P13_WORDS)
    img_dir = P13_DIR / "images"
    img_dir.mkdir(parents=True)
    images, img_bytes = [str(FIXTURE_JPEG)], 0
    for i in range(P13_IMAGES - 1):
        h, w = int(rng.integers(200, 481)), int(rng.integers(240, 641))
        p = str(img_dir / f"{i:06d}.png")
        write_png(p, _p13_image(rng, h, w))
        images.append(p)
    img_bytes = sum(os.path.getsize(p) for p in images)
    images_s = time.perf_counter() - t0
    # the committed JPEG decodes to the pixels PIL gave for it
    want = np.load(FIXTURE_JPEG.with_name("baseline_420_rst.pil.npy"))
    check(np.array_equal(read_image(str(FIXTURE_JPEG)), want),
          "13a: the JPEG fixture differs from its PIL pixels")

    def text(n):
        return " ".join(words[j] for j in rng.integers(0, len(words), n))

    passages = Table.from_dict({
        "passage_id": [f"evqa_p{i}" for i in range(P13_PASSAGES)],
        "passage_content": [text(int(rng.integers(30, 60))) for _ in range(P13_PASSAGES)],
        "source_name": ["evqa"] * P13_PASSAGES})

    def questions(n, prefix):
        pos = rng.integers(0, P13_PASSAGES, n)
        content = passages["passage_content"]
        rows = {"question_id": [f"{prefix}{i}" for i in range(n)],
                # each question shares words with its positive passage
                "question": [" ".join(content[p].split()[:6]) + " " + text(4) for p in pos],
                "instruction": ["Answer the following question with the image:"] * n,
                "img_path": [images[int(j)] for j in rng.integers(0, len(images), n)],
                "answers": [[words[int(j)]] for j in rng.integers(0, len(words), n)],
                "pos_item_ids": [[f"evqa_p{p}"] for p in pos],
                "source_name": ["evqa"] * n}
        rows["gold_answer"] = [a[0] for a in rows["answers"]]
        return Table.from_dict(rows)

    data = {"train": questions(P13_TRAIN, "train_q"), "test": questions(P13_TEST, "test_q")}
    corpus = {"train_passages": passages, "test_passages": passages}
    t1 = time.perf_counter()
    arrow_io.save_to_disk(data, str(P13_DIR / "EVQA_data"))
    arrow_io.save_to_disk(corpus, str(P13_DIR / "EVQA_passages"))
    write_s = time.perf_counter() - t1
    nbytes = sum(f.stat().st_size for d in ("EVQA_data", "EVQA_passages")
                 for f in (P13_DIR / d).rglob("*.arrow"))
    t1 = time.perf_counter()
    back = {**arrow_io.load_from_disk(str(P13_DIR / "EVQA_data")),
            **arrow_io.load_from_disk(str(P13_DIR / "EVQA_passages"))}
    read_s = time.perf_counter() - t1
    for split, table in {**data, **corpus}.items():
        check(back[split] == table, f"13a: {split} read back differs from what was written")
    distinct = len(set(back["train"]["img_path"]) | set(back["test"]["img_path"]))
    check(distinct >= P13_IMAGES // 2, f"13a: {distinct} distinct images")
    return {"phase": "p13a_real_format_data", "questions": {k: len(v) for k, v in data.items()},
            "passages": P13_PASSAGES, "arrow_bytes": nbytes,
            "write_seconds": write_s, "write_mb_per_s": nbytes / write_s / 1e6,
            "read_seconds": read_s, "read_mb_per_s": nbytes / read_s / 1e6,
            "images": len(images), "distinct_images_used": distinct,
            "jpeg_fixture": {"path": str(FIXTURE_JPEG.relative_to(FIXTURE_JPEG.parents[2])),
                             "equals_pil_pixels": True},
            "image_bytes": img_bytes, "image_write_seconds": images_s,
            "host_seconds_note": "host clock; the card is idle in 13a", "card": smi,
            "seconds": time.perf_counter() - t0}, words


def _p13_config(base, transforms):
    """``configs/evqa_flmr.json`` with its M2KR node pointed at 13a's
    directories (through the ``///`` convention), 13's paths, the
    vocabulary of 13a, and ``transforms`` inserted before its Wrap node."""
    import copy

    cfg = copy.deepcopy(base)
    cfg["meta"]["EXPERIMENT_FOLDER"] = str(P13_DIR / "experiments")
    dp = cfg["data_pipeline"]
    dp["cache_dir"] = str(P13_DIR / "cache")
    t = dp["transforms"]
    t["input:LoadM2KR"]["setup_kwargs"].update(
        data_path=f"{P13_DIR / 'EVQA_data'}///EVQA_data",
        passage_path=f"{P13_DIR / 'EVQA_passages'}///EVQA_passages")
    last = "input:LoadM2KR"
    for node, spec in transforms.items():
        t[node] = {**spec, "input_node": last}
        last = node
    t["process:Wrap"]["input_node"] = last
    out = t["output:PrepareDataloaders"]["setup_kwargs"]
    out["datasets_config"]["valid"][0]["split"] = "test"  # 13a writes train and test
    for tok in out["tokenizer_config"].values():
        tok["TokenizerModelVersion"] = str(P13_DIR / "vocab")
    return cfg


def _p13_cli(cfg, name, mode, *opts):
    """``cli.main`` with ``cfg``, written beside its experiment folder."""
    from reranking_multimodal_retrievers_tpu_torch.cli.main import main as cli_main

    path = Path(cfg["meta"]["EXPERIMENT_FOLDER"]).parent / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(cfg, f)
    rc = cli_main(["--config", str(path), "--mode", mode, "--opts", *opts])
    check(rc == 0, f"cli {name} --mode {mode}: exit {rc}")


def _keep_calls(store):
    """A function wrapper that keeps (args, kwargs, result) of the first
    call and the seconds of every call."""
    def make(orig):
        def kept(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig(*args, **kwargs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            store.setdefault("seconds", []).append(dt)
            if not store.setdefault("calls", []):
                store["calls"].append((args, kwargs, out))
            return out
        return kept
    return make


def _step_logits(model, images, kwargs):
    """The logits of each greedy step of ``blip2_greedy_captions`` on
    ``images`` (each decoder pass's row of the step's position), and the
    captions."""
    from reranking_multimodal_retrievers_tpu_torch.data.ops import infoseek_ops

    steps, orig = [], model.decode_logits

    def record(*args):
        out = orig(*args)
        steps.append(out[:, len(steps)].float())
        return out

    model.decode_logits = record
    try:
        caps = infoseek_ops.blip2_greedy_captions(model, *images, **kwargs)
    finally:
        del model.decode_logits
    return steps, caps


def _node_timer(store):
    """``BaseTransform.__call__`` wrapped: each node's (seconds, output) by
    its node id."""
    def make(orig):
        def timed(self, data=None):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig(self, data)
            torch.cuda.synchronize()
            store[self.name] = (time.perf_counter() - t, out)
            return out
        return timed
    return make


def p13_prepare(smi, words, base):
    """13b: ``cli.main --mode prepare_data`` over 13a's directories through
    CaptionImageWithBLIP2v3 (its checkpoint written here first),
    ExtractImageFeaturesWithViTv2 and PrepareDistillationScores, each
    model on the card; the first batch of each held against its plain
    version (the CPU for the ViT). Returns (the line, K2 rows, launches)."""
    from reranking_multimodal_retrievers_tpu_torch.data.ops import (distillation_ops,
                                                                    feature_ops, infoseek_ops)
    from reranking_multimodal_retrievers_tpu_torch.data.transforms import BaseTransform
    from reranking_multimodal_retrievers_tpu_torch.models import bert as bert_mod
    from reranking_multimodal_retrievers_tpu_torch.models import checkpoint_dir
    from reranking_multimodal_retrievers_tpu_torch.models import t5 as t5_mod
    from reranking_multimodal_retrievers_tpu_torch.models.blip2 import (
        Blip2ForConditionalGeneration)
    from reranking_multimodal_retrievers_tpu_torch.models.tokenization import write_test_vocab
    from reranking_multimodal_retrievers_tpu_torch.models.vit import (CLIPVisionConfig,
                                                                       CLIPVisionModel)

    t0 = time.perf_counter()
    write_test_vocab(str(P13_DIR / "vocab" / "vocab.txt"), words)
    tok_path, tok_pieces = _p13_tokenizer(words)
    tok_rates = _p13_tokenizer_rates(tok_path, words)
    tok_rates["spiece_model_route"] = _p13_spiece_route(words)
    # the captioner's HF-named checkpoint: random weights from the seed
    # (T5's relative-position tables at std REL_BIAS_STD, as phase 5 draws
    # them, so that the head bias moves attention), fp32 as HF stores them
    cap_cfg = _p13_captioner_config()
    wgen = torch.Generator(device="cuda").manual_seed(SEED)
    model = Blip2ForConditionalGeneration(_without_kernel(cap_cfg), device="cuda",
                                          generator=wgen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("relative_attention_bias.weight"):
                p.copy_(torch.randn(p.shape, device="cuda", generator=wgen) * REL_BIAS_STD)
    n_params = sum(p.numel() for p in model.parameters())
    (P13_DIR / "captioner").mkdir()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ckpt_bytes = checkpoint_dir.write_safetensors(
        str(P13_DIR / "captioner" / "model.safetensors"), model.state_dict())
    ckpt_write_s = time.perf_counter() - t1
    del model
    gc.collect()
    torch.cuda.empty_cache()

    with open(CONFIGS / FLMR_CONFIG) as f:
        teacher = json.load(f)["model_config"]["flmr"]
    teacher["text_config"]["use_pallas_attention"] = True
    blip2 = {k: dataclasses.asdict(getattr(cap_cfg, k))
             for k in ("vision_config", "qformer_config", "text_config")}
    blip2["num_query_tokens"] = cap_cfg.num_query_tokens
    cfg = _p13_config(base, {
        "process:Caption": {"transform_name": "CaptionImageWithBLIP2v3", "setup_kwargs": {
            "captioner_checkpoint": str(P13_DIR / "captioner"),
            "tokenizer_name": tok_path, "blip2_config": blip2, "prompt": P13_PROMPT,
            "max_caption_length": 20, "batch_size": 8,
            "caption_store_dir": str(P13_DIR / "store")}},
        "process:ViT": {"transform_name": "ExtractImageFeaturesWithViTv2", "setup_kwargs": {
            "vision_config": P13_VIT, "batch_size": 16, "cache_folder": str(P13_DIR / "store")}},
        "process:Distill": {"transform_name": "PrepareDistillationScores", "setup_kwargs": {
            "flmr_config": teacher, "num_negatives": P13_NEGATIVES}}})
    cfg["data_pipeline"]["transforms"]["input:LoadM2KR"]["setup_kwargs"]["num_data"] = {
        "train": P13_NUM_DATA, "test": P13_NUM_DATA}
    caps, vits, scores, loads, nodes, stores = {}, {}, {}, [], {}, {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    reset_counts()
    with _Recorder() as rec:
        rec.patch(infoseek_ops, "blip2_greedy_captions", _keep_calls(caps))
        rec.patch(checkpoint_dir, "load_checkpoint_dir", _clock(loads))
        rec.patch(feature_ops.ExtractImageFeaturesWithViT, "_encode_batch", _keep_calls(vits))
        rec.patch(distillation_ops.PrepareDistillationScores, "score", _keep_calls(scores))
        rec.patch(BaseTransform, "__call__", _node_timer(nodes))
        rec.patch(t5_mod, "fused_self_attention", _first_inputs(stores.setdefault("t5", {}),
                                                                _k2_key))
        rec.patch(bert_mod, "fused_self_attention", _first_inputs(stores.setdefault("bert", {}),
                                                                  _k2_key))
        _p13_cli(cfg, "p13_prepare", "prepare_data")
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t1
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches["K2f32"] > 0 and launches["K1"] == launches["K2"] == launches["K3"] == 0,
          f"13b launches {launches}")
    out = nodes["process:Distill"][1]
    for split in ("train", "test"):
        t = out[split]
        check(len(t) == P13_NUM_DATA and all(isinstance(c, str) for c in t["caption"])
              and all(len(f) == P13_VIT["hidden_size"] and np.isfinite(f).all()
                      for f in t["image_features"]), f"13b: the {split} split's outputs")
    check(all(len(s) == 1 + P13_NEGATIVES and np.isfinite(s).all()
              for s in out["train"]["scores"]), "13b: the teacher's scores")

    # the first caption batch through the plain path: greedy tokens equal up
    # to near-ties
    (args, kwargs, first_caps), = caps["calls"]
    model, rest = args[0], args[1:3]  # (tokenizer, images)
    tok = rest[0]
    check(type(tok).__name__ == "UnigramTokenizer" and kwargs.get("prompt") == P13_PROMPT,
          f"13b: the captioner's tokenizer {type(tok).__name__} and prompt")
    fed = []
    orig_encode = model.encode_for_generation
    model.encode_for_generation = lambda ids, *a: fed.append(ids.cpu()) or orig_encode(ids, *a)
    try:
        k_steps, again = _step_logits(model, rest, kwargs)
    finally:
        del model.encode_for_generation
    check(again == first_caps, "13b: the first caption batch is not deterministic")
    # the prompt's ids the encoder took: the prompt's pieces, </s>, padding
    want_ids = ([tok_pieces.index("▁" + w) + 3 for w in P13_PROMPT.split()] + [tok.eos_token_id])
    want_ids += [tok.pad_token_id] * (P13_PROMPT_TOKENS - len(want_ids))
    check(all(row.tolist() == want_ids for row in fed[0]),
          f"13b: prompt ids {fed[0][0].tolist()} vs the pieces' {want_ids}")
    plain = _plain_twin(model)
    p_steps, _ = _step_logits(plain, rest, kwargs)
    k_tok = torch.stack([s.argmax(-1) for s in k_steps], 1).cpu().numpy()
    p_tok = torch.stack([s.argmax(-1) for s in p_steps], 1).cpu().numpy()
    gaps = torch.stack([torch.topk(s, 2).values.diff(dim=-1).abs()[:, 0] for s in k_steps],
                       1).cpu().numpy()
    ties = []
    for r in range(k_tok.shape[0]):
        low = np.nonzero(gaps[r] < NEAR_TIE)[0]
        upto = int(low[0]) + 1 if len(low) else k_tok.shape[1]
        ties.append(None if not len(low) else int(low[0]))
        check(np.array_equal(k_tok[r, :upto], p_tok[r, :upto]),
              f"13b: caption {r} tokens {k_tok[r]} vs the plain path {p_tok[r]}")

    def caption_text(row):  # what blip2_greedy_captions decodes of a row
        ids = []
        for t in row.tolist():
            if t == tok.eos_token_id:
                break
            ids.append(t)
        return tok.decode(ids, skip_special_tokens=True)
    for r in range(k_tok.shape[0]):
        check(first_caps[r] == caption_text(k_tok[r]),
              f"13b: caption {r} {first_caps[r]!r} vs its tokens' decoding")
        if ties[r] is None:
            check(first_caps[r] == caption_text(p_tok[r]), f"13b: caption {r} "
                  f"{first_caps[r]!r} vs the plain path's {caption_text(p_tok[r])!r}")
    step_err = max((a - b).abs().max().item() for a, b in zip(k_steps, p_steps))
    del plain, model, k_steps, p_steps
    caps["calls"].clear()
    gc.collect()
    torch.cuda.empty_cache()

    # the first teacher batch through the plain path
    (args, _, first_scores), = scores["calls"]
    node, teacher_model, q_enc, d_enc = args
    s_kernel = node.score(teacher_model, q_enc, d_enc)
    s_plain = node.score(_plain_twin(teacher_model), q_enc, d_enc)
    check(np.array_equal(s_kernel, first_scores), "13b: the first teacher batch is not "
          "deterministic")
    check(np.allclose(s_kernel, s_plain, rtol=K2F32_RTOL, atol=K2F32_ATOL),
          f"13b: teacher scores {s_kernel[:2]} vs the plain path {s_plain[:2]}")
    teacher_err = float(np.abs(s_kernel - s_plain).max())
    del args, node, teacher_model
    scores["calls"].clear()

    # the first ViT rows on the CPU in fp32
    (args, _, first_vit), = vits["calls"]
    vit_node = args[0]
    paths = first_vit["img_path"][:P13_VIT_CPU_ROWS]
    cpu_vit = CLIPVisionModel(CLIPVisionConfig(**P13_VIT), device="meta")
    cpu_vit.load_state_dict({k: v.cpu() for k, v in vit_node._model.state_dict().items()},
                            assign=True)
    _, proc, _ = vit_node._build_encoder()
    pix = torch.as_tensor(proc([feature_ops._read_or_blank(p, P13_VIT["image_size"])
                                for p in paths]))
    with torch.no_grad():
        want = cpu_vit.eval()(pix)["last_hidden_state"][:, 0].numpy()
    got = np.asarray(first_vit["image_features"][:P13_VIT_CPU_ROWS], np.float32)
    vit_err = _rel_err(got, want)
    check(vit_err <= CLI_LOGIT_TOL, f"13b: ViT features vs CPU fp32: {vit_err}")
    del args, vit_node, cpu_vit, first_vit
    vits["calls"].clear()
    gc.collect()
    torch.cuda.empty_cache()

    rows = _k2_rows(stores, "13b", launches["K2f32"])
    enc_rows = cap_cfg.num_query_tokens + P13_PROMPT_TOKENS
    check(any(shape[1] == enc_rows for shape, _ in stores["t5"]),
          f"13b: no T5 encoder launch at {enc_rows} rows: {list(stores['t5'])}")
    cap_s = nodes["process:Caption"][0]
    vit_s, dist_s = nodes["process:ViT"][0], nodes["process:Distill"][0]
    n_rows = 2 * P13_NUM_DATA
    line = {"phase": "p13b_prepare_data", "captioner_params": n_params,
            "checkpoint_bytes": ckpt_bytes, "checkpoint_write_seconds": ckpt_write_s,
            "checkpoint_write_gb_per_s": ckpt_bytes / ckpt_write_s / 1e9,
            "checkpoint_read_seconds": sum(t for t, _ in loads),
            "node_seconds": {k: v[0] for k, v in nodes.items()},
            "captions": n_rows, "captions_per_s": n_rows / cap_s,
            "caption_batch_seconds": caps["seconds"],
            "images_per_s": n_rows / vit_s, "teacher_questions": P13_NUM_DATA,
            "teacher_questions_per_s": P13_NUM_DATA / dist_s,
            "tokenizer": {**tok_rates, "prompt": P13_PROMPT, "prompt_ids": want_ids},
            "first_caption_batch": {"captions": first_caps[:2], "tokens_equal_up_to_near_ties":
                                    True, "captions_equal_plain_decoding": True,
                                    "near_tie_step": ties,
                                    "min_top2_gap": float(gaps.min()),
                                    "max_abs_logit_diff": step_err},
            "first_teacher_batch": {"max_abs_err_vs_plain": teacher_err,
                                    "tol": [K2F32_RTOL, K2F32_ATOL]},
            "first_vit_rows_vs_cpu_fp32": {"rows": P13_VIT_CPU_ROWS, "rel_err": vit_err,
                                           "tol": CLI_LOGIT_TOL},
            "cuts": {"rows_prepared": f"{P13_NUM_DATA} of each split (LoadPreprocessedData's "
                                      "num_data)",
                     "vit_rows_vs_cpu": f"{P13_VIT_CPU_ROWS} of the first batch's 16, for time"},
            "k2f32_shapes": {r["variant"]: r["launches"] for r in rows},
            "launches": launches, "peak_memory_gb": peak_gb, "wall_seconds": wall, "card": smi,
            "seconds": time.perf_counter() - t0}
    return line, rows, launches


def _p13_full_width(cfg):
    """``cfg`` with ``synth_flmr_fullsize.json``'s FLMR block (BERT-base,
    ViT-B/32, dim 128), Ks and train/valid/test blocks: the full-width path
    (``configs/evqa_flmr.json``'s own block, 64 wide with 4 heads, runs in
    13e)."""
    with open(CONFIGS / FLMR_CONFIG) as f:
        full = json.load(f)
    cfg["model_config"]["flmr"] = full["model_config"]["flmr"]
    cfg["model_config"]["Ks"] = full["model_config"]["Ks"]
    for mode in ("train", "valid", "test"):
        cfg[mode] = full[mode]
    return cfg


def p13_train_test(smi, cfg, part, n_train, n_test, corpus, steps=P13_STEPS, int8=True,
                   want_k2=True, train_pallas=False, test_opts=(), validate=False, keep=None):
    """13c, 13d, 13e and 16: FLMR ``--mode train`` (``steps`` steps, with
    ``use_pallas_attention`` as ``train_pallas`` says; validation off unless
    ``validate``, then as ``cfg`` has it) and ``--mode test`` (K1 and, where
    ``want_k2``, K2's fp32 path; then, where ``int8``, K3 over an int8
    index; ``test_opts`` on both) from ``cli.main`` with ``cfg`` (an EVQA
    config's pipeline over a part's data). ``keep``, a dict, receives the
    first test's index, its first 8 query matrices and its dump. Returns
    (the lines, K1 row, K3 row or None, K2 rows, launch counts)."""
    from reranking_multimodal_retrievers_tpu_torch.engine import search as search_mod
    from reranking_multimodal_retrievers_tpu_torch.executors import FLMRExecutor
    from reranking_multimodal_retrievers_tpu_torch.models import bert as bert_mod

    exp = (Path(cfg["meta"]["EXPERIMENT_FOLDER"]) / cfg["meta"]["experiment_name"]
           / "version_0")
    run = f"p{part.replace(' ', '_')}_flmr"
    pallas = "model_config.flmr.text_config.use_pallas_attention=true"
    lines, parts = [], {}

    t0 = time.perf_counter()
    n_steps = steps
    steps = []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with _Recorder() as rec:
        rec.patch(FLMRExecutor, "training_step", _clock(steps))
        _p13_cli(cfg, run, "train", f"train.trainer_paras.limit_train_batches={n_steps}",
                 "train.trainer_paras.max_epochs=1", "train.trainer_paras.log_every_n_steps=1",
                 *([] if validate else ["valid.trainer_paras.limit_val_batches=0"]),
                 *([pallas] if train_pallas else []))
    trained = parts[f"{part}_train"] = read_counts()
    # training launches nothing; its validation, where it runs, searches by K1
    check(sum(trained.values()) == trained["K1"] and (trained["K1"] > 0) == validate,
          f"{part} training launched {trained}")
    check(len(steps) == n_steps, f"{part} took {len(steps)} steps")
    losses = [m["ib_loss"] for m in _metrics_lines(exp) if "ib_loss" in m]
    check(len(losses) > 0 and np.isfinite(losses).all(), f"{part} losses {losses}")
    batch = cfg["train"]["batch_size"]
    lines.append({"phase": f"{run}_train", "steps": len(steps), "batch": batch,
                  "cuts": {"steps": f"{n_steps} of an epoch's {n_train // batch}"},
                  "use_pallas_attention": train_pallas, "validation": validate,
                  "steps_per_s": _steps_per_s(steps), "examples_per_s": batch * _steps_per_s(steps),
                  "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "ib_losses": losses, "launches": trained, "card": smi,
                  "seconds": time.perf_counter() - t0})

    def test(name, *opts):
        t0 = time.perf_counter()
        idx_log, q_log, s_log, k1_in, k3_in, k2_in = [], [], [], {}, {}, {}
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with _Recorder() as rec:
            rec.patch(FLMRExecutor, "build_index", _clock(idx_log))
            rec.patch(FLMRExecutor, "encode_queries", _clock(q_log))
            rec.patch(search_mod.Searcher, "search", _clock(s_log))
            rec.patch(search_mod, "maxsim_scores",
                      _first_inputs(k1_in, lambda Q, D, M=None, *r: tuple(Q.shape)))
            rec.patch(search_mod, "maxsim_scores_int8",
                      _first_inputs(k3_in, lambda Qq, *r: tuple(Qq.shape)))
            rec.patch(bert_mod, "fused_self_attention", _first_inputs(k2_in, _k2_key))
            _p13_cli(cfg, run, "test", f"meta.experiment_dir='{exp}'", pallas, *test_opts,
                     *opts)
        torch.cuda.synchronize()
        launches = read_counts()
        dump = _dump(exp)
        preds = dump["predictions"]
        check(len(preds) == n_test and all(
            np.isfinite([d["score"] for d in p["top_ranking_passages"]]).all() for p in preds),
            f"{name}: the prediction dump")
        index = idx_log[0][1]
        index_s = sum(t for t, _ in idx_log)
        query_s = sum(t for t, _ in q_log) + sum(t for t, _ in s_log)
        m = dump["metrics"]
        if keep is not None and not keep:
            keep.update(index=index, dump=dump, queries=torch.cat([q for _, q in q_log[:8]])[:8])
        line = {"phase": name, "docs": index.num_docs, "doc_tokens": list(index.mask.shape),
                "queries": len(preds), "corpus_docs_per_s": index.num_docs / index_s,
                "index_seconds": index_s, "queries_per_s": len(preds) / query_s,
                **{k: v for k, v in m.items() if "recall_at_5" in k},
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": launches, "card": smi, "seconds": time.perf_counter() - t0}
        return line, k1_in, k3_in, k2_in

    line, k1_in, _, k2_in = test(f"{run}_test")
    tested = parts[f"{part}_test"] = line["launches"]
    check(tested["K1"] > 0 and (tested["K2f32"] > 0) == want_k2 and tested["K2"] == 0
          and tested["K3"] == 0, f"{part} test launches {tested}")
    text = cfg["model_config"]["flmr"]["text_config"]
    line["head_geometry"] = [text["num_attention_heads"],
                             text["hidden_size"] // text["num_attention_heads"]]
    lines.append(line)
    (_, k1_entry), = k1_in.items()
    k1_row = dict(k1_line(*k1_entry["args"][:3], f"CLI test over {corpus}, L_d = 64 ({part})"),
                  launches=tested["K1"])
    if not int8:
        rows = _k2_rows({"bert": k2_in}, part, tested["K2f32"]) if want_k2 else []
        return lines, k1_row, None, rows, parts
    line, _, k3_in, k2_in_int8 = test(f"{run}_test_int8", "model_config.modules="
                                      "['freeze_vision_encoders','use_int8_index']")
    tested_int8 = parts[f"{part}_test_int8"] = line["launches"]
    check(tested_int8["K3"] > 0 and tested_int8["K1"] == 0,
          f"{part} int8 test launches {tested_int8}")
    lines.append(line)
    (_, k3_entry), = k3_in.items()
    k3_row = dict(k3_line(*k3_entry["args"][:5], f"CLI int8 test over {corpus}, L_d = 64 "
                          f"({part})"), launches=tested_int8["K3"])
    for key, entry in k2_in_int8.items():  # the int8 test's encoders run the same shapes
        k2_in.setdefault(key, {"calls": 0, **{k: v for k, v in entry.items() if k != "calls"}})
        k2_in[key]["calls"] += entry["calls"]
    rows = _k2_rows({"bert": k2_in}, part, tested["K2f32"] + tested_int8["K2f32"])
    return lines, k1_row, k3_row, rows, parts


# 13d: the committed parquet snapshot and images (tests/fixtures/, written
# by tests/fixtures/make_m2kr_parquet.py with pyarrow and PIL; their
# digests in tests/fixtures/digests.json)
FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures"
P13D_SNAPSHOT = FIXTURES / "m2kr_snapshot"
# the same rows re-encoded (ZSTD, LZ4_RAW, DELTA_BYTE_ARRAY and
# DELTA_LENGTH_BYTE_ARRAY on data pages v2), which 13d and 13e train and
# test over, its images the WebP re-encodings of m2kr_images under their names
P13D_SNAPSHOT_V2 = FIXTURES / "m2kr_snapshot_v2"
P13D_IMAGES = FIXTURES / "m2kr_images"
P13D_IMAGES_WEBP = FIXTURES / "m2kr_images_webp"
P13D_WEBP = FIXTURES / "webp_images"
P13E_STEPS = 8  # three past TIMED_FROM, for a steps/s
# 32 of the 256 test queries (each query's WebP image decoded on the host)
P13E_TEST_BATCHES = 8
# 13d's loader depth (its rows' WebP images decode on the host): 10 train
# steps and 64 of the 256 test queries, cut to keep the script's time
P13D_STEPS = 10
P13D_TEST_BATCHES = 4  # 64 of the 256 queries
P13E_CONFIGS = ("evqa_flmr.json", "synth_flmr.json")
P13D_CODECS = FIXTURES / "codec_images"
P13D_TOKENIZER = FIXTURES / "unigram_tokenizer"
P13D_JPEG_CODING = FIXTURES / "jpeg_coding"
P13D_PASSES = 2  # passes over the tables and the images; the best is kept


def _rows_digest(rows):
    """SHA-256 of a table's rows as canonical JSON (keys sorted, bytes as
    hex), as ``make_m2kr_parquet.py`` digests pyarrow's rows."""
    import hashlib

    import datetime

    def hexed(obj):  # dates, times and timestamps as ISO text and nanoseconds
        if isinstance(obj, bytes):
            return {"bytes": obj.hex()}
        if isinstance(obj, (datetime.date, datetime.time)):
            return {"iso": datetime.datetime.isoformat(obj)
                    if isinstance(obj, datetime.datetime) else obj.isoformat(),
                    "ns": getattr(obj, "nanosecond", None)}
        raise TypeError(type(obj).__name__)

    text = json.dumps(rows, sort_keys=True, ensure_ascii=False, default=hexed)
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def _pixels_digest(rgb):
    """SHA-256 of an RGB image with its shape, as ``make_m2kr_parquet.py``
    digests PIL's pixels."""
    import hashlib

    rgb = np.ascontiguousarray(rgb, np.uint8)
    return hashlib.sha256(f"{rgb.shape}".encode() + rgb.tobytes()).hexdigest()


def _image_format(name, data=None):
    if data is not None and data[:4] == b"RIFF":
        from reranking_multimodal_retrievers_tpu_torch.data.webp import webp_variant

        return webp_variant(data).replace(" (extended)", "")
    for prefix, fmt in (("gif_", "GIF"), ("bmp_rle", "BMP, RLE"), ("bmp_", "BMP"),
                        ("tiff_", "TIFF")):
        if name.startswith(prefix):
            return fmt
    if name.startswith("base_"):
        return "baseline JPEG"
    if name.startswith("prog_"):
        return "progressive JPEG"
    if name.startswith("smooth_"):
        return "progressive JPEG, block smoothing"
    if name.startswith(("cmyk_", "ycck_")):
        return "CMYK/YCCK JPEG"
    if name.startswith("arith_seq_"):
        return "arithmetic-coded JPEG"
    if name.startswith("arith_prog_"):
        return "arithmetic-coded progressive JPEG"
    if name.startswith("lossless_"):
        return "lossless JPEG"
    return "PNG, Adam7" if "adam7" in name else "PNG"


def _best_pass(fn):
    """(the best host seconds of P13D_PASSES calls, the last result)."""
    best, out = float("inf"), None
    for _ in range(P13D_PASSES):
        t = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t)
    return best, out


def _parquet_codecs(path):
    """The codecs of a parquet file's column chunks, as one name (``"+"``
    between several), from its footer."""
    import struct as _struct

    from reranking_multimodal_retrievers_tpu_torch.data import parquet_io

    data = Path(path).read_bytes()
    (n,) = _struct.unpack_from("<I", data, len(data) - 8)
    meta = parquet_io._Compact(data, len(data) - 8 - n).struct()
    codecs = {parquet_io.CODECS.get(c[3][4], str(c[3][4])) for rg in meta[4] for c in rg[1]}
    return "+".join(sorted(codecs))


def p13d_read(smi):
    """13d's reads: every committed parquet table and image against its
    digest, the snapshot's two configs through ``_load_hf`` with the row
    counts of its README, parquet MB/s and images/s by format. Returns
    (the line, the splits' sizes, the snapshot's words)."""
    import hashlib

    from reranking_multimodal_retrievers_tpu_torch.data import image_io, parquet_io
    from reranking_multimodal_retrievers_tpu_torch.data.ops.infoseek_ops import (
        load_caption_tokenizer)
    from reranking_multimodal_retrievers_tpu_torch.data.ops.m2kr_ops import _load_hf

    t0 = time.perf_counter()
    with open(FIXTURES / "digests.json") as f:
        digests = json.load(f)
    tables = sorted(digests["tables"])
    nbytes = sum((FIXTURES / rel).stat().st_size for rel in tables)
    read_s, read = _best_pass(lambda: {rel: parquet_io.read_parquet(str(FIXTURES / rel))
                                       for rel in tables})
    for rel, table in read.items():
        check(_rows_digest(list(table)) == digests["tables"][rel],
              f"13d: {rel} read differs from pyarrow's rows")
    snap_bytes = sum(f.stat().st_size for f in P13D_SNAPSHOT.rglob("*.parquet"))
    load_s, loaded = _best_pass(lambda: {**_load_hf(f"{P13D_SNAPSHOT}///EVQA_data"),
                                         **_load_hf(f"{P13D_SNAPSHOT}///EVQA_passages")})
    sizes = {k: len(v) for k, v in loaded.items()}
    with open(P13D_SNAPSHOT / "README.md") as f:
        info = parquet_io.front_matter(f.read())["dataset_info"]
    check(sizes == {sp["name"]: sp["num_examples"] for c in info for sp in c["splits"]},
          f"13d: snapshot splits {sizes} against its README")
    # the re-encoded copy: its files digest as the SNAPPY snapshot's, and it
    # loads to the same rows; parquet MB/s by the codecs a file uses
    for rel in tables:
        if rel.startswith("m2kr_snapshot/"):
            twin = rel.replace("m2kr_snapshot/", "m2kr_snapshot_v2/", 1)
            check(digests["tables"].get(twin) == digests["tables"][rel],
                  f"13d: {twin} does not digest as {rel}")
    v2_bytes = sum(f.stat().st_size for f in P13D_SNAPSHOT_V2.rglob("*.parquet"))
    v2_s, v2 = _best_pass(lambda: {**_load_hf(f"{P13D_SNAPSHOT_V2}///EVQA_data"),
                                   **_load_hf(f"{P13D_SNAPSHOT_V2}///EVQA_passages")})
    check({k: len(t) for k, t in v2.items()} == sizes
          and all(list(v2[k]) == list(loaded[k]) for k in sizes),
          "13d: the re-encoded snapshot loads to other rows")
    by_codec = {}
    for rel in tables:
        by_codec.setdefault(_parquet_codecs(FIXTURES / rel), []).append(rel)
    codec_rates = {}
    for codec, rels in sorted(by_codec.items()):
        n = sum((FIXTURES / rel).stat().st_size for rel in rels)
        secs, _ = _best_pass(lambda: [parquet_io.read_parquet(str(FIXTURES / rel))
                                      for rel in rels])
        codec_rates[codec] = {"files": len(rels), "bytes": n, "seconds": secs,
                              "mb_per_s": n / secs / 1e6}
    # the variants this slice reads: BROTLI by level, INT96, dates/times/timestamps
    variant_rates = {}
    for kind in ("brotli_1_", "brotli_11_", "int96_", "temporal_"):
        rels = [rel for rel in tables if Path(rel).name.startswith(kind)]
        check(len(rels) > 0, f"13d: no committed {kind}* table")
        n = sum((FIXTURES / rel).stat().st_size for rel in rels)
        secs, _ = _best_pass(lambda: [parquet_io.read_parquet(str(FIXTURES / rel))
                                      for rel in rels])
        variant_rates[kind.rstrip("_")] = {"files": len(rels), "bytes": n, "seconds": secs,
                                           "mb_per_s": n / secs / 1e6}
    formats = {}
    for key, folder in (("images", P13D_IMAGES), ("codec_images", P13D_CODECS),
                        ("webp_images", P13D_WEBP), ("m2kr_images_webp", P13D_IMAGES_WEBP),
                        ("jpeg_coding", P13D_JPEG_CODING)):
        for name in sorted(digests[key]):
            fmt = _image_format(name, (folder / name).read_bytes())
            formats.setdefault(fmt, []).append((name, folder / name, digests[key][name]))
    per_format = {}
    for fmt, entries in formats.items():
        names = [name for name, _, _ in entries]
        paths = [str(path) for _, path, _ in entries]
        secs, pixels = _best_pass(lambda: [image_io.read_image(p) for p in paths])
        for (name, _, digest), px in zip(entries, pixels):
            check(_pixels_digest(px) == digest, f"13d: {name} decodes differently from PIL")
        n_px = sum(px.shape[0] * px.shape[1] for px in pixels)
        per_format[fmt] = {"images": len(names), "megapixels": n_px / 1e6, "seconds": secs,
                           "images_per_s": len(names) / secs,
                           "megapixels_per_s": n_px / secs / 1e6}
    # the datasets Image column, and the Unigram tokenizer, against the
    # digests of datasets' and the tokenizers library's own results
    columns = {}
    for rel, digest in digests["image_columns"].items():
        secs, table = _best_pass(lambda: parquet_io.read_parquet(str(FIXTURES / rel)))
        hashes = [_pixels_digest(px) for px in table["image"]]
        check(hashlib.sha256(json.dumps(hashes).encode()).hexdigest() == digest,
              f"13d: {rel}'s Image column differs from datasets' decoding")
        columns[rel] = {"rows": len(table), "seconds": secs}
    tok_d = digests["tokenizer"]
    tok = load_caption_tokenizer(str(P13D_TOKENIZER))
    ids = [tok.encode(t) for t in tok_d["texts"]]
    decoded = [tok.decode(i, skip_special_tokens=True) for i in ids]
    check(type(tok).__name__ == "UnigramTokenizer"
          and hashlib.sha256(json.dumps(ids).encode()).hexdigest() == tok_d["ids"]
          and hashlib.sha256(json.dumps(decoded, ensure_ascii=False).encode("utf-8"))
          .hexdigest() == tok_d["decoded"],
          "13d: the Unigram tokenizer's ids or strings differ from the tokenizers library's")
    same = {}
    for name in ("prog_420_large.jpg", "base_420_large.jpg"):  # the same 320 x 240 content
        same[name] = _best_pass(lambda: image_io.read_image(str(P13D_IMAGES / name)))[0]
    line = {"phase": "p13d_read", "tables": len(tables), "parquet_bytes": nbytes,
            "parquet_read_seconds": read_s, "parquet_mb_per_s": nbytes / read_s / 1e6,
            "snapshot_bytes": snap_bytes, "snapshot_load_seconds": load_s,
            "snapshot_mb_per_s": snap_bytes / load_s / 1e6, "splits": sizes,
            "snapshot_v2_bytes": v2_bytes, "snapshot_v2_load_seconds": v2_s,
            "snapshot_v2_mb_per_s": v2_bytes / v2_s / 1e6, "parquet_by_codec": codec_rates,
            "parquet_by_variant": variant_rates,
            "images": per_format, "image_columns": columns,
            "tokenizer_texts_equal_digests": len(tok_d["texts"]),
            "progressive_vs_baseline_320x240": {
                "progressive_ms": same["prog_420_large.jpg"] * 1e3,
                "baseline_ms": same["base_420_large.jpg"] * 1e3,
                "ratio": same["prog_420_large.jpg"] / same["base_420_large.jpg"]},
            "digests_equal": True, "host_seconds_note": "host clock, best of "
            f"{P13D_PASSES} passes; the card is idle in these reads", "card": smi,
            "seconds": time.perf_counter() - t0}
    return line, sizes, _table_words(loaded)


def _table_words(tables):
    """The sorted lower-case words of the tables' question, instruction and
    passage columns: a test vocabulary's words for the snapshot."""
    import re

    text = [t for table in tables.values() for col in ("question", "instruction",
                                                        "passage_content")
            if col in table.column_names for t in table[col]]
    return sorted({w for t in text for w in re.findall(r"[a-z0-9]+", t.lower())})


def _p13d_config(base, part="13d", root=P13_DIR, snapshot=P13D_SNAPSHOT_V2,
                 images=P13D_IMAGES_WEBP):
    """An EVQA config (``configs/evqa_flmr.json`` for 13d and 13e,
    ``evqa_flmr_G.json`` for 16) with its M2KR node pointed at a committed
    snapshot through the ``///`` convention (13d's re-encoded copy by
    default), the rows' images at ``images`` (their WebP re-encodings by
    default), a part's paths under ``root`` and the vocabulary written
    there (13d then takes :func:`_p13_full_width`'s widths, 13e its own)."""
    import copy

    cfg = copy.deepcopy(base)
    cfg["meta"]["EXPERIMENT_FOLDER"] = str(root / f"experiments_{part}")
    dp = cfg["data_pipeline"]
    dp["cache_dir"] = str(root / f"cache_{part}")
    dp["transforms"]["input:LoadM2KR"]["setup_kwargs"].update(
        data_path=f"{snapshot}///EVQA_data", passage_path=f"{snapshot}///EVQA_passages",
        image_root_folder=str(images))
    out = dp["transforms"]["output:PrepareDataloaders"]["setup_kwargs"]
    for tok in out["tokenizer_config"].values():
        tok["TokenizerModelVersion"] = str(root / "vocab_snapshot")
    return cfg


def p13d_phase(smi, base):
    """13d under ``P13_DIR``; prints its lines. Returns (K1 row, K3 row, K2
    rows, launch counts of each run)."""
    from reranking_multimodal_retrievers_tpu_torch.models.tokenization import write_test_vocab

    t0 = time.perf_counter()
    line, sizes, words = p13d_read(smi)
    emit(line)
    write_test_vocab(str(P13_DIR / "vocab_snapshot" / "vocab.txt"), words)
    cfg = _p13_full_width(_p13d_config(base))
    lines, k1_row, k3_row, rows, parts = p13_train_test(
        smi, cfg, "13d", sizes["train"], P13D_TEST_BATCHES * cfg["test"]["batch_size"],
        "the parquet snapshot's 8,192 passages", steps=P13D_STEPS,
        test_opts=(f"test.trainer_paras.limit_test_batches={P13D_TEST_BATCHES}",))
    for line in lines:
        emit(line)
    emit({"phase": "p13d", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    rows_e, parts_e = p13e_phase(smi, base, sizes)
    emit({"phase": "p13e", "seconds": time.perf_counter() - t0})
    return k1_row, k3_row, rows + rows_e, {**parts, **parts_e}


def p13e_phase(smi, base, sizes):
    """13e: ``cli.main`` with ``use_pallas_attention=true`` over 13d's
    re-encoded snapshot at two head geometries, ``P13E_STEPS`` train steps
    and a test each. ``evqa_flmr.json`` as published (4 heads x 16, which
    the JAX gate refuses: K2 never launches, in training or test); its FLMR
    block with ``synth_flmr.json``'s text tower (4 heads x 32: the test
    launches K2's fp32 path; training keeps the flag off, K2 having no
    backward; synth_flmr's own block has no vision tower for the rows'
    images). Returns (K2 rows, launch counts)."""
    import copy

    with open(CONFIGS / "synth_flmr.json") as f:
        synth = json.load(f)["model_config"]["flmr"]["text_config"]
    rows, parts = [], {}
    for config in P13E_CONFIGS:
        tag = config.split(".")[0]
        cfg = _p13d_config(base, f"13e_{tag}")
        if tag == "synth_flmr":
            cfg["model_config"]["flmr"]["text_config"] = copy.deepcopy(synth)
        train_pallas = tag == "evqa_flmr"
        batches = P13E_TEST_BATCHES
        lines, _, _, k2_rows, got = p13_train_test(
            smi, cfg, f"13e {tag}", sizes["train"], batches * cfg["test"]["batch_size"],
            "the re-encoded snapshot's passages", steps=P13E_STEPS, int8=False,
            want_k2=tag != "evqa_flmr", train_pallas=train_pallas,
            test_opts=(f"test.trainer_paras.limit_test_batches={batches}",))
        for line in lines:
            emit(line)
        rows += k2_rows
        parts.update(got)
    return rows, parts


def p13_phases(smi, only_13d=False):
    """Phase 13 (13a-13d, or 13d alone); prints each part's line. Returns
    (K1 rows, K3 rows, K2 rows, launch counts of each part)."""
    import os

    os.environ.pop("RMRT_PLATFORM", None)  # the CLI and its nodes run on the card
    if P13_DIR.exists():
        shutil.rmtree(P13_DIR)
    with open(CONFIGS / "evqa_flmr.json") as f:
        base = json.load(f)
    try:
        if only_13d:
            k1_d, k3_d, rows_d, parts_d = p13d_phase(smi, base)
            return [k1_d], [k3_d], rows_d, parts_d
        line, words = p13_real_format_data(smi)
        emit(line)
        line, k2_rows, launches = p13_prepare(smi, words, base)
        emit(line)
        lines, k1_row, k3_row, rows, parts = p13_train_test(
            smi, _p13_full_width(_p13_config(base, {})), "13c", P13_TRAIN,
            16 * P13C_TEST_BATCHES, "13a's corpus",
            test_opts=(f"test.trainer_paras.limit_test_batches={P13C_TEST_BATCHES}",))
        for line in lines:
            emit(line)
        k1_d, k3_d, rows_d, parts_d = p13d_phase(smi, base)
    finally:
        if P13_DIR.exists():
            shutil.rmtree(P13_DIR)
    parts["13b"] = launches
    return [k1_row, k1_d], [k3_row, k3_d], k2_rows + rows + rows_d, {**parts, **parts_d}


# ---- phase 3d: raw images into the main path (ops/preprocess.py on the card),
# ---- phase 14: the tools (tools/*.py, ops/host_ops.py)

P14_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_p14"
# 3d: 16 uint8 images at each of phase 13a's PNG sizes, H x W, to CLIP
# ViT-B/32's 224
P3D_RES, P3D_PER_RES, P3D_SIZE = ((480, 640), (640, 480), (240, 320), (200, 300)), 16, 224
# the same function on the card and on the CPU: fp32 products with TF32 off,
# summed in another order (2.2e-5 at most between the CPU and JAX in
# tests/test_torch_preprocess.py)
P3D_PIXEL_TOL = 1e-4
# against the host path (data/image_io.py, 8-bit rounding after each resize
# pass, as PIL): tests/test_preprocess.py:36-37's bounds
P3D_HOST_MEAN, P3D_HOST_MAX = 0.05, 0.75
# top-100 of the card-preprocessed queries against the CPU-preprocessed
# ones: the pixels differ by <= 1e-4 before the cast to bf16, which rounds a
# few of them the other way (on the CPU, with 4% of the pixels of this FLMR's
# queries so rounded, scores of 26-31 moved by up to 0.033); the values may
# differ by this much, and the ranks only between docs within it
P3D_TOPK_ATOL = 0.1
# 14a: BEM triples at BEMScorer's default 512 tokens, each score held
# against the CPU's fp32 one (a cut for time)
P14_BEM_EXAMPLES, P14_BEM_TOL = 64, 1e-4
# 14b: the top-100 of this many 3d queries, packed token by token
P14_HOST_QUERIES = 8
P14_WORDS = ["what", "which", "who", "where", "animal", "city", "color", "river", "capital",
             "country", "cat", "dog", "bird", "horse", "paris", "rome", "london", "berlin",
             "red", "blue", "green", "nile", "thames", "rhine", "france", "italy", "england",
             "germany", "is", "this", "the", "of", "and", "in", "a"]


def p3d_images(rng):
    """``P3D_PER_RES`` uint8 RGB images at each of ``P3D_RES``: smooth
    fields (8 x 8 x 3 noise, bilinearly upsampled, stretched to 0-255) with
    +-6 levels of pixel noise."""
    out = []
    for h, w in P3D_RES:
        base = torch.from_numpy(rng.normal(size=(P3D_PER_RES, 3, 8, 8)).astype(np.float32))
        up = torch.nn.functional.interpolate(base, size=(h, w), mode="bilinear",
                                             align_corners=False)
        lo = up.amin(dim=(1, 2, 3), keepdim=True)
        hi = up.amax(dim=(1, 2, 3), keepdim=True)
        x = (up - lo) / (hi - lo) * 243 + 6
        x = x + torch.from_numpy(rng.integers(-6, 7, size=x.shape).astype(np.float32))
        out.append(x.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous().numpy())
    return out


def p3d_raw_images(flmr, index, smi):
    """Phase 3d: 64 raw images preprocessed on the card
    (``CLIPImageProcessorDevice``), their queries encoded by phase 3's FLMR
    and searched through RetrievalService over phase 3's index; K1 and K2
    against their plain versions at 3d's launch shapes, the pixels against
    the same function on the CPU and against the host path, the top-100
    against that of CPU-preprocessed queries. Returns (the phase's line,
    what phase 14 takes from it, K1's rows, K2's rows)."""
    from reranking_multimodal_retrievers_tpu_torch.data.image_io import CLIPImageProcessor
    from reranking_multimodal_retrievers_tpu_torch.engine import make_search_fn
    from reranking_multimodal_retrievers_tpu_torch.engine import search as search_mod
    from reranking_multimodal_retrievers_tpu_torch.models import bert as bert_mod
    from reranking_multimodal_retrievers_tpu_torch.models.checkpoint_dir import (
        write_safetensors)
    from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_cuda import maxsim_scores
    from reranking_multimodal_retrievers_tpu_torch.ops.preprocess import CLIPImageProcessorDevice
    from reranking_multimodal_retrievers_tpu_torch.serving import RetrievalService

    t0 = time.perf_counter()
    if P14_DIR.exists():
        shutil.rmtree(P14_DIR)
    rng = np.random.default_rng([SEED, 3])
    batches = p3d_images(rng)
    n = sum(len(b) for b in batches)
    n_all, lq = index.num_padded_docs, 32
    q_ids = [torch.as_tensor(rng.integers(1000, 29000, size=(len(b), lq))) for b in batches]
    q_am = torch.ones(P3D_PER_RES, lq, dtype=torch.int64)

    def encode(pix, ids):
        with torch.inference_mode():
            out = flmr.query(ids.cuda(), q_am.cuda(), pixel_values=pix.to(torch.bfloat16))
        return out.late_interaction_output

    # the main path: upload, preprocess, encode, serve
    proc = CLIPImageProcessorDevice(P3D_SIZE, device="cuda")
    svc = RetrievalService(make_search_fn(n_all, k=100), index, batch_queries=P3D_PER_RES,
                           max_wait_ms=50)
    k1_in, k2_in = {}, {}
    reset_counts()
    try:
        with _Recorder() as rec:
            rec.patch(search_mod, "maxsim_scores",
                      _first_inputs(k1_in, lambda Q, D, M=None, *r: (tuple(Q.shape),
                                                                     tuple(D.shape))))
            rec.patch(bert_mod, "fused_self_attention", _first_inputs(k2_in, _k2_bf16_key))
            t1 = time.perf_counter()
            pix_dev = [proc(b) for b in batches]
            Q_dev = torch.cat([encode(p, ids) for p, ids in zip(pix_dev, q_ids)])
            results = [f.result(timeout=600) for f in [svc.search(Q_dev[i]) for i in range(n)]]
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t1
    finally:
        svc.close()
    launches = read_counts()
    check(launches["K1"] > 0 and launches["K2"] > 0 and launches["K2f32"] == 0,
          f"3d launches {launches}")

    # K1 and K2 against their plain versions on the first inputs 3d gave
    # them at each launch shape (not the main path's launches)
    k1_rows = [dict(k1_line(*e["args"][:3], f"3d raw-image queries {'x'.join(map(str, qs))} "
                            f"over a {ds[0]}-doc slab"), launches=e["calls"])
               for (qs, ds), e in k1_in.items()]
    k2_rows = [k2_bf16_line(e, f"key bias {'x'.join(map(str, shape))} (3d query encoder)")
               for (shape, _), e in k2_in.items()]
    check(sum(r["launches"] for r in k1_rows) == launches["K1"]
          and sum(r["launches"] for r in k2_rows) == launches["K2"],
          "3d: K1 or K2 launches at shapes not recorded")
    del k1_in, k2_in
    check(all(len(ids) == 100 and np.isfinite(v).all() for ids, v in results), "3d results")

    # images/s: the card's path (upload + preprocess) and the host path
    # (resize on the host + upload), the same decoded uint8 images
    def on_card():
        for b in batches:
            proc(b)
        torch.cuda.synchronize()

    host = CLIPImageProcessor(P3D_SIZE)
    pix_host = []

    def on_host():
        pix_host[:] = [torch.from_numpy(host(list(b))).cuda() for b in batches]
        torch.cuda.synchronize()

    # each the best of 3 timed passes, after the main path's pass (the card)
    # or a warm pass (the host)
    card_s = min(_timed(on_card) for _ in range(3))
    on_host()
    host_s = min(_timed(on_host) for _ in range(3))

    # the pixels against the same function on the CPU and the host path
    cpu_proc = CLIPImageProcessorDevice(P3D_SIZE, device="cpu")
    pix_cpu = [cpu_proc(b) for b in batches]
    dev_cpu = max((d.cpu() - c).abs().max().item() for d, c in zip(pix_dev, pix_cpu))
    check(dev_cpu <= P3D_PIXEL_TOL, f"3d pixels: card vs CPU {dev_cpu} > {P3D_PIXEL_TOL}")
    diffs = [(d - h).abs() for d, h in zip(pix_dev, pix_host)]
    host_mean = float(torch.cat([d.flatten() for d in diffs]).mean())
    host_max = max(d.max().item() for d in diffs)
    check(host_mean < P3D_HOST_MEAN and host_max < P3D_HOST_MAX,
          f"3d pixels vs the host path: mean {host_mean}, max {host_max}")

    # the top-100 of CPU-preprocessed queries (not the main path)
    Q_cpu = torch.cat([encode(p.cuda(), ids) for p, ids in zip(pix_cpu, q_ids)])
    search = make_search_fn(n_all, k=100)
    want_vals, want_idx = search(Q_cpu, index.embeddings, index.mask)
    got_vals = np.stack([v for _, v in results]).astype(np.float32)
    got_ids = np.asarray([[int(d) for d in ids] for ids, _ in results])
    topk_err = same_top_k(got_vals, got_ids, want_vals.cpu().numpy(), want_idx.cpu().numpy(),
                          P3D_TOPK_ATOL, 0.0)
    identical = int(sum(np.array_equal(g, w) for g, w in zip(got_ids, want_idx.cpu().numpy())))
    same_sets = int(sum(set(g) == set(w) for g, w in zip(got_ids, want_idx.cpu().numpy())))

    # for 14b: the first queries' top-100 docs, their token scores packed
    # doc by doc (fp32 products of the bf16 matrices), and K1's scores
    packed, doclens, k1_vals = [], [], []
    for i in range(P14_HOST_QUERIES):
        docs = torch.as_tensor(got_ids[i], device="cuda")
        D, M = index.embeddings[docs], index.mask[docs]
        rows = D.float()[M]  # the valid token rows, doc after doc
        packed.append((rows @ Q_dev[i].float().t()).cpu().numpy())
        doclens.append(M.sum(dim=1).cpu().numpy().astype(np.int32))
        k1_vals.append(maxsim_scores(Q_dev[i:i + 1], D, M)[0].cpu().numpy())
    full = maxsim_scores(Q_dev[:P14_HOST_QUERIES], index.embeddings, index.mask)

    # for 14c: phase 3's FLMR as an HF directory, and its output on one batch
    P14_DIR.mkdir(parents=True, exist_ok=True)
    hf = P14_DIR / "flmr_hf"
    hf.mkdir(exist_ok=True)
    t1 = time.perf_counter()
    hf_bytes = write_safetensors(str(hf / "model.safetensors"), flmr.state_dict())
    hf_s = time.perf_counter() - t1
    line = {"phase": "retrieve_raw_images", "images": n,
            "resolutions": [list(r) for r in P3D_RES], "image_size": P3D_SIZE,
            "images_per_s_card": n / card_s, "images_per_s_host": n / host_s,
            "card_preprocess_seconds": card_s, "host_preprocess_seconds": host_s,
            "main_path_seconds": main_s, "pixels_card_vs_cpu_max": dev_cpu,
            "pixels_vs_host_mean": host_mean, "pixels_vs_host_max": host_max,
            "tol": {"cpu": P3D_PIXEL_TOL, "host_mean": P3D_HOST_MEAN, "host_max": P3D_HOST_MAX,
                    "top_k_atol": P3D_TOPK_ATOL},
            "top100_identical_rankings": identical, "top100_same_sets": same_sets,
            "top100_max_abs_err": topk_err,
            "hf_checkpoint_bytes": hf_bytes, "hf_checkpoint_write_seconds": hf_s,
            "k1_shapes": {r["variant"]: r["launches"] for r in k1_rows},
            "k2_shapes": {r["variant"]: r["launches"] for r in k2_rows},
            "launches": launches, "card": smi, "seconds": time.perf_counter() - t0}
    carry = {"packed": packed, "doclens": doclens, "k1": k1_vals, "full": full.cpu().numpy(),
             "ids": got_ids, "vals": got_vals, "cpu_ids": want_idx.cpu().numpy(),
             "cpu_vals": want_vals.cpu().numpy(), "pix": pix_dev[0].cpu(), "q_ids": q_ids[0],
             "q_out": Q_dev[:P3D_PER_RES].cpu()}
    return line, carry, k1_rows, k2_rows


def _timed(fn):
    t = time.perf_counter()
    fn()
    return time.perf_counter() - t


def p14_bem(smi):
    """14a: a seeded BERT-base BEM classifier written as an HF directory,
    ``P14_BEM_EXAMPLES`` triples scored through BEMScorer on the card (K2's
    fp32 path) and held against the same weights on the CPU in fp32.
    Returns (the line, K2's fp32 row, launches)."""
    from reranking_multimodal_retrievers_tpu_torch.models import bert as bert_mod
    from reranking_multimodal_retrievers_tpu_torch.models.bert import BertConfig
    from reranking_multimodal_retrievers_tpu_torch.models.checkpoint_dir import (
        write_safetensors)
    from reranking_multimodal_retrievers_tpu_torch.models.tokenization import (
        WordPieceTokenizer, write_test_vocab)
    from reranking_multimodal_retrievers_tpu_torch.tools.eval_evqa import (
        BEMClassifier, BEMScorer)

    t0 = time.perf_counter()
    cfg = BertConfig(type_vocab_size=4, use_pallas_attention=True)
    seeded = BEMClassifier(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
    ckpt = P14_DIR / "bem"
    ckpt.mkdir(parents=True, exist_ok=True)
    write_safetensors(str(ckpt / "model.safetensors"), seeded.state_dict())
    del seeded
    tok = WordPieceTokenizer(write_test_vocab(str(P14_DIR / "vocab.txt"), P14_WORDS))
    rng = np.random.default_rng([SEED, 14])
    kinds = ["automatic", "templated", "multi_answer", "2_hop", "list"]

    def words(lo, hi):
        return " ".join(rng.choice(P14_WORDS, size=int(rng.integers(lo, hi + 1))))

    examples = [{"question": words(3, 12), "reference": words(1, 4), "candidate": words(1, 6),
                 "question_type": kinds[i % len(kinds)]} for i in range(P14_BEM_EXAMPLES)]
    for ex in examples[2::len(kinds)]:
        ex["reference"] = ex["reference"].replace(" ", " && ", 1)
    card = BEMScorer(tok, checkpoint_dir=str(ckpt), device="cuda")
    cpu = BEMScorer(tok, checkpoint_dir=str(ckpt), device="cpu")
    check(card.max_length == 512, f"14a: BEMScorer's max length {card.max_length}")
    card(examples[0])  # warm-up (cuBLAS, the kernel's library)
    k2_in = {}
    reset_counts()
    with _Recorder() as rec:
        rec.patch(bert_mod, "fused_self_attention", _first_inputs(k2_in, _k2_key))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = np.asarray([card(ex, threshold_score=False) for ex in examples])
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t1
    launches = read_counts()
    check(launches["K2f32"] == 12 * P14_BEM_EXAMPLES and launches["K2"] == 0,
          f"14a launches {launches}")
    t1 = time.perf_counter()
    enc = [cpu.encode(ex) for ex in examples]
    want = []
    with torch.inference_mode():
        for i in range(0, len(enc), 16):
            ids, am, tt = (torch.from_numpy(np.concatenate([e[j] for e in enc[i:i + 16]]))
                           for j in range(3))
            want.append(torch.softmax(cpu.model(ids, am, tt), dim=-1)[:, 1].numpy())
    want = np.concatenate(want)
    cpu_s = time.perf_counter() - t1
    err = float(np.abs(got - want).max())
    check(err <= P14_BEM_TOL, f"14a BEM scores: card vs CPU fp32 {err} > {P14_BEM_TOL}")
    far = np.abs(want - 0.5) > P14_BEM_TOL
    check(np.array_equal((got >= 0.5)[far], (want >= 0.5)[far]), "14a BEM decisions")
    rows = _k2_rows({"bert": k2_in}, "14a BEM scorer", launches["K2f32"])
    line = {"phase": "tools_bem", "examples": P14_BEM_EXAMPLES, "max_length": card.max_length,
            "examples_per_s": P14_BEM_EXAMPLES / card_s, "card_seconds": card_s,
            "cpu_check_seconds": cpu_s, "max_abs_err_vs_cpu_fp32": err, "tol": P14_BEM_TOL,
            "mean_score": float(got.mean()), "share_equivalent": float((got >= 0.5).mean()),
            "launches": launches, "card": smi, "seconds": time.perf_counter() - t0}
    return line, rows, launches


def p14_host_ops(carry, smi):
    """14b: ``segmented_maxsim_host`` over 3d's top-100 docs' packed token
    scores against K1's scores of those docs; ``top_k_host`` over K1's
    scores of every doc against ``torch.topk``."""
    from reranking_multimodal_retrievers_tpu_torch.ops import host_ops

    t0 = time.perf_counter()
    t1 = time.perf_counter()
    check(host_ops.native_available(), "14b: the host library did not build")
    build_s = time.perf_counter() - t1
    seg_s, seg_err = 0.0, 0.0
    for scores, doclens, k1 in zip(carry["packed"], carry["doclens"], carry["k1"]):
        t1 = time.perf_counter()
        got = host_ops.segmented_maxsim_host(scores, doclens)
        seg_s += time.perf_counter() - t1
        seg_err = max(seg_err, float(np.abs(got - k1).max()))
    check(seg_err <= K1_TOL, f"14b segmented_maxsim_host vs K1: {seg_err} > {K1_TOL}")
    full = carry["full"]
    t1 = time.perf_counter()
    top = np.stack([host_ops.top_k_host(row, 100) for row in full])
    topk_host_s = time.perf_counter() - t1
    dev = torch.from_numpy(full).cuda()
    vals, idx = torch.topk(dev, 100, dim=1)
    topk_card_ms = cuda_ms(lambda: torch.topk(dev, 100, dim=1), 10)
    same = np.take_along_axis(full, top, axis=1)
    check(np.array_equal(same, vals.cpu().numpy()), "14b top_k_host values vs torch.topk")
    identical = int(sum(np.array_equal(a, b) for a, b in zip(top, idx.cpu().numpy())))
    n_rows = int(sum(len(p) for p in carry["packed"]))
    return {"phase": "tools_host_ops", "build_seconds": build_s,
            "segmented_maxsim": {"queries": len(carry["packed"]), "packed_rows": n_rows,
                                 "query_tokens": int(carry["packed"][0].shape[1]),
                                 "seconds": seg_s, "max_abs_err_vs_k1": seg_err,
                                 "tol": K1_TOL},
            "top_k": {"rows": int(full.shape[0]), "n": int(full.shape[1]), "k": 100,
                      "host_seconds": topk_host_s, "torch_topk_card_ms": topk_card_ms,
                      "identical_orders": identical},
            "card": smi, "seconds": time.perf_counter() - t0}


def p14_convert(carry, fcfg, smi):
    """14c: phase 3's FLMR (written as an HF directory in 3d) through
    ``convert_torch_to_port``, loaded by ``FLMRExecutor.load_checkpoint`` into
    a bf16 model on the card, whose query output on 3d's first batch must
    equal the source model's bitwise; then ``export_npz``."""
    from reranking_multimodal_retrievers_tpu_torch.executors.flmr_executor import FLMRExecutor
    from reranking_multimodal_retrievers_tpu_torch.models import FLMRModelForRetrieval
    from reranking_multimodal_retrievers_tpu_torch.tools.convert_checkpoint import (
        convert_torch_to_port, export_npz)

    t0 = time.perf_counter()
    config = P14_DIR / "flmr_config.json"
    flmr = {k: v for k, v in dataclasses.asdict(fcfg).items()
            if k not in ("text_config", "vision_config")}
    flmr["text_config"] = dataclasses.asdict(fcfg.text_config)
    flmr["vision_config"] = dataclasses.asdict(fcfg.vision_config)
    config.write_text(json.dumps({"model_config": {"flmr": flmr}}))
    t1 = time.perf_counter()
    out = convert_torch_to_port(str(P14_DIR / "flmr_hf"), str(P14_DIR / "flmr_port"),
                                str(config))
    convert_s = time.perf_counter() - t1
    ex = object.__new__(FLMRExecutor)
    ex.device = torch.device("cuda")
    ex.global_step = 0
    ex.model = FLMRModelForRetrieval(fcfg, device="cuda", dtype=torch.bfloat16).eval()
    t1 = time.perf_counter()
    ex.load_checkpoint(str(Path(out) / "params"))
    load_s = time.perf_counter() - t1
    with torch.inference_mode():
        q = ex.model.query(carry["q_ids"].cuda(), torch.ones_like(carry["q_ids"]).cuda(),
                           pixel_values=carry["pix"].cuda().to(torch.bfloat16))
    check(torch.equal(q.late_interaction_output.cpu(), carry["q_out"]),
          "14c: the converted checkpoint's query output differs from the source model's")
    del ex, q
    t1 = time.perf_counter()
    npz = export_npz(str(Path(out) / "params"), str(P14_DIR / "flmr.npz"))
    npz_s = time.perf_counter() - t1
    with np.load(npz) as f:
        n_arrays = len(f.files)
    return {"phase": "tools_convert_checkpoint", "convert_seconds": convert_s,
            "load_seconds": load_s,
            "port_checkpoint_bytes": (Path(out) / "params" / "state.pt").stat().st_size,
            "npz_bytes": Path(npz).stat().st_size, "npz_arrays": n_arrays,
            "export_npz_seconds": npz_s, "query_output_bitwise_equal": True,
            "card": smi, "seconds": time.perf_counter() - t0}


def p14_job(smi):
    """14d: the ``--dummy`` train job of ``configs/okvqa_flmr.json`` rendered
    by ``render_job`` and run with bash on the card (180 s limit): rc 0 and
    a ``metrics.jsonl``."""
    import os

    from reranking_multimodal_retrievers_tpu_torch.tools.submit_jobs import render_job

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    exp = P14_DIR / "experiments"
    path = render_job(str(CONFIGS / "okvqa_flmr.json"), "train", "p14_smoke", workdir=str(root),
                      dummy=True, out_dir=str(P14_DIR / "jobs"),
                      opts=[f"meta.EXPERIMENT_FOLDER={exp}",
                            f"data_pipeline.cache_dir={P14_DIR / 'cache'}"])
    gc.collect()
    torch.cuda.empty_cache()  # the job's process allocates on the same card
    bindir = P14_DIR / "bin"  # the script runs `python`: this interpreter, by its own path
    bindir.mkdir(exist_ok=True)
    (bindir / "python").write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    (bindir / "python").chmod(0o755)
    env = {k: v for k, v in os.environ.items() if k != "RMRT_PLATFORM"}
    env.update(PATH=f"{bindir}:{env.get('PATH', '')}", PYTHONPATH=str(root))
    out = subprocess.run(["bash", path], capture_output=True, text=True, timeout=180, env=env)
    check(out.returncode == 0, f"14d job rc {out.returncode}: {out.stderr[-2000:]}")
    metrics = sorted(exp.rglob("metrics.jsonl"))
    check(bool(metrics) and metrics[0].read_text().strip() != "", "14d: no metrics.jsonl")
    return {"phase": "tools_job_script", "script": Path(path).name, "rc": out.returncode,
            "metrics_lines": len(metrics[0].read_text().strip().splitlines()),
            "card": smi, "seconds": time.perf_counter() - t0}


def p14_dumps(carry, smi):
    """14e: a prediction dump in the executors' format from 3d's results
    (the card-preprocessed queries' top-100 as the list, the CPU-preprocessed
    ones' as the raw list, a seeded positive in each), reduced by
    ``reduce_retrieval_file`` and read by ``analysis``."""
    import pickle

    from reranking_multimodal_retrievers_tpu_torch.tools import analysis
    from reranking_multimodal_retrievers_tpu_torch.tools.reduce_retrieval_file import (
        reduce_retrieval_file)

    t0 = time.perf_counter()
    rng = np.random.default_rng([SEED, 15])

    def plist(ids, vals):
        return [{"passage_id": str(d), "content": f"passage {d}", "score": float(v)}
                for d, v in zip(ids, vals)]

    preds = []
    for i, (ids, vals) in enumerate(zip(carry["ids"], carry["vals"])):
        pos = str(ids[int(rng.integers(0, 20))])
        preds.append({"question_id": f"q{i}", "pos_item_ids": [pos], "answers": [pos],
                      "top_ranking_passages": plist(ids, vals),
                      "raw_top_ranking_passages": plist(carry["cpu_ids"][i],
                                                        carry["cpu_vals"][i])})
    path = P14_DIR / "test_predictions_rank_0.json"
    path.write_text(json.dumps({"metrics": {}, "predictions": preds}))
    t1 = time.perf_counter()
    reduced = reduce_retrieval_file(str(path))
    reduce_s = time.perf_counter() - t1
    with open(reduced, "rb") as f:
        slim = pickle.load(f)["predictions"]
    check(all(set(p) == {"passage_id", "score"} for e in slim for p in e["top_ranking_passages"])
          and [e["question_id"] for e in slim] == [e["question_id"] for e in preds],
          "14e: the reduced dump")
    raw = [{**e, "top_ranking_passages": e["raw_top_ranking_passages"]} for e in preds]
    sweep = analysis.rerank_vs_list_size(raw, preds, Ds=[5, 20, 100], k=5, use_answers=False)
    mc = analysis.mcnemar_test(preds, k=5)
    check(all(0.0 <= v <= 1.0 for v in sweep.values()) and 0.0 <= mc["p_value"] <= 1.0
          and mc["a"] + mc["b"] + mc["c"] + mc["d"] == len(preds), "14e: the analysis")
    return {"phase": "tools_prediction_dumps", "queries": len(preds),
            "dump_bytes": path.stat().st_size, "reduced_bytes": Path(reduced).stat().st_size,
            "reduce_seconds": reduce_s, "recall_at_5_by_list_size": sweep, "mcnemar": mc,
            "card": smi, "seconds": time.perf_counter() - t0}


def p14_phases(carry, fcfg, smi):
    """Phase 14 (14a-14e); prints each part's line. Returns (K2's fp32 rows,
    the launch counts of 14a, the main path of this phase)."""
    try:
        line, rows, launches = p14_bem(smi)
        emit(line)
        emit(p14_host_ops(carry, smi))
        emit(p14_convert(carry, fcfg, smi))
        emit(p14_job(smi))
        emit(p14_dumps(carry, smi))
    finally:
        if P14_DIR.exists():
            shutil.rmtree(P14_DIR)
    return rows, launches


# ---- phase 15: several ranks (parallel/: the mesh over torch.distributed)

# 4 ranks: one a card over NCCL where there are 4 cards, else sharing the
# card(s) over gloo (NCCL refuses two ranks on one device); the line names it
P15_RANKS = 4
# 15c: phase 3's index size, drawn a slab at a time from a per-slab seed so
# that each rank draws only its block; every 1,000th doc whole padding
P15_DOCS, P15_SLAB, P15_K = 100_000, 8192, 100
# 15b: phase 3's corpus encode, 1,024 docs in batches of 128
P15_ENC_DOCS, P15_ENC_BATCH = 1024, 128
# 15c: the K1/K3 checks at the shard's launch shape compare these many docs
# against the plain version (the plain scores of a whole shard would need
# 23 GB); the plain time is the plain version over the whole shard in
# blocks of that size
P15_CHECK_DOCS = 2048
# 15e: prompts a family scores; on one card the ranks' tensor-parallel
# all-reduces go through the host (gloo), so the card run scores fewer
P15_PROMPTS = {"nccl": 100, "gloo": 10}
# 15a/15b/15d/15e: a rank's result against the one-process result on the
# same card and weights. 15b: the same batches through the same kernels;
# 15d: bf16 GEMMs of 25 rows in place of 100 may pick other kernels (a few
# bf16 spacings); 15e: tensor-parallel products sum two bf16 halves where
# one GEMM sums all (the same order of error as bf16 itself, P_YES_TOL)
P15_ENC_ATOL = 2 ** -7
P15_RERANK_ATOL = 0.05
P15_RANK_TIMEOUT = 600
P15_CLI_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_p15"
P15_CLI_STEPS = 10
# 15a: warm steps timed after the checked step and the NaN batch, where the
# ranks have a card each (on one card a gloo step takes seconds)
P15_TIMED_STEPS = {"nccl": 5, "gloo": 0}
# phase 3's and 4's traffic: 8 queries of 32 tokens and a 224-pixel image,
# token matrices of dim 128; 100 candidates of 512 tokens a query
P15_QUERIES, P15_Q_TOKENS, P15_IMAGE, P15_DIM, P15_RERANK_L = 8, 32, 224, 128, 512


def _p15_wall(mesh, fn):
    """(result, seconds) of ``fn()`` on every rank, between two barriers."""
    mesh.barrier()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    mesh.barrier()
    return out, time.perf_counter() - t


def _p15_train_batch():
    """Phase 8's global batch: 16 queries x (1 + 1) docs of 256 tokens."""
    rng = np.random.default_rng(SEED + 15)
    B, NW, LQ, LD = TRAIN_B, TRAIN_NWAY, TRAIN_LQ, TRAIN_LD
    return dict(
        query_input_ids=rng.integers(1000, 29000, size=(B, LQ)),
        query_attention_mask=np.ones((B, LQ), np.int64),
        query_pixel_values=rng.normal(size=(B, 3, P15_IMAGE, P15_IMAGE)).astype(np.float32),
        context_input_ids=rng.integers(1000, 29000, size=(B * NW, LD)),
        context_attention_mask=np.ones((B * NW, LD), np.int64))


def _p15_train(batch, mesh=None, timed_steps=0):
    """One phase-8 step (fp32, AdamW, the vision tower frozen) over
    ``batch`` (the global batch; each rank keeps its rows) from the seed's
    weights, on one process (``mesh`` None) or over ``mesh`` (split over
    its model axis when it has one). Returns the metrics, each checked
    leaf's averaged gradient, its value before and after (whole), whether
    the vision tower stayed bitwise and the (cold) step's seconds; then one
    batch with a NaN pixel in the first query (one data shard) must be
    skipped; then ``timed_steps`` more steps, each timed."""
    from reranking_multimodal_retrievers_tpu_torch.models import FLMRModelForRetrieval
    from reranking_multimodal_retrievers_tpu_torch.parallel import shard_batch, tp_shard_module
    from reranking_multimodal_retrievers_tpu_torch.parallel.tensor_parallel import gather_param
    from reranking_multimodal_retrievers_tpu_torch.training import TrainState, make_train_step

    model = FLMRModelForRetrieval(flmr_train_config(), device="cuda",
                                  generator=torch.Generator(device="cuda").manual_seed(SEED))
    opt, sched, labels = flmr_optimizer(model)
    tp = mesh is not None and mesh.n_model > 1
    if tp:
        tp_shard_module(mesh, model, opt)
    leaves = {n: model.get_parameter(n) for n in FLMR_CHECKED_LEAVES}
    before = {n: gather_param(p).cpu().clone() for n, p in leaves.items()}
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if labels[n] == "frozen"}
    grads = {}
    hook = opt.register_step_pre_hook(lambda *a: grads.update(
        {n: gather_param(p, p.grad).cpu().clone() for n, p in leaves.items()}))
    step = make_train_step(model, opt, sched, mesh=mesh, tensor_parallel=tp)
    state = TrainState.create(model, opt, sched)
    local = (shard_batch(mesh, batch) if mesh is not None
             else {k: torch.as_tensor(v).cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    if mesh is not None:
        (state, met), seconds = _p15_wall(mesh, lambda: step(state, local))
    else:
        t = time.perf_counter()
        state, met = step(state, local)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
    hook.remove()
    out = {"metrics": {k: float(v) for k, v in met.items()}, "grads": grads, "before": before,
           "after": {n: gather_param(p).cpu().clone() for n, p in leaves.items()},
           "labels": labels,
           "frozen_bitwise": all(torch.equal(model.get_parameter(n), v)
                                 for n, v in frozen.items()),
           "step_seconds": seconds}
    if mesh is not None:
        bad = dict(batch)
        bad["query_pixel_values"] = batch["query_pixel_values"].copy()
        bad["query_pixel_values"][0, 0, 0, 0] = np.nan
        keep = {n: p.detach().clone() for n, p in model.named_parameters()}
        state, met = step(state, shard_batch(mesh, bad))
        out["nan_skipped"] = float(met["grads_finite"]) == 0.0 and all(
            torch.equal(p, keep[n]) for n, p in model.named_parameters())
        out["local_query_rows"] = int(leaves[FLMR_CHECKED_LEAVES[0]].shape[0])
    warm = []
    for _ in range(timed_steps):
        if mesh is not None:
            (state, _), seconds = _p15_wall(mesh, lambda: step(state, local))
        else:
            t = time.perf_counter()
            state, _ = step(state, local)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
        warm.append(seconds)
    out["warm_step_seconds"] = warm
    del model, opt, sched, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


P15_BERT_KW = dict(use_pallas_attention=True, attention_scores_bf16=True,
                   gelu_approximate=True)


def _p15_flmr_config():
    """Phase 3's FLMR config: ``use_pallas_attention`` (K2) in BERT."""
    from reranking_multimodal_retrievers_tpu_torch.models import (
        BertConfig, CLIPVisionConfig, FLMRConfig)

    return FLMRConfig(text_config=BertConfig(**P15_BERT_KW), vision_config=CLIPVisionConfig(),
                      dim=128, mapping_network_prefix_length=32,
                      use_transformer_mapping_network=True,
                      transformer_mapping_num_hidden_layers=1)


def _p15_flmr_bf16():
    """Phase 3's FLMR in bf16 with the seed's weights."""
    from reranking_multimodal_retrievers_tpu_torch.models import FLMRModelForRetrieval

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return FLMRModelForRetrieval(_p15_flmr_config(), device="cuda", dtype=torch.bfloat16,
                                 generator=gen).eval()


def _p15_corpus():
    """Phase 3's 1,024 docs (ids and masks) and 8 queries (32 tokens, an
    image each)."""
    rng = np.random.default_rng(SEED)
    LD = TRAIN_LD
    dlen = rng.integers(LD // 8, LD + 1, size=P15_ENC_DOCS)
    d_am = (np.arange(LD)[None, :] < dlen[:, None]).astype(np.int64)
    d_ids = rng.integers(1000, 29000, size=(P15_ENC_DOCS, LD)) * d_am
    q_ids = rng.integers(1000, 29000, size=(P15_QUERIES, P15_Q_TOKENS))
    pix = rng.normal(size=(P15_QUERIES, 3, P15_IMAGE, P15_IMAGE)).astype(np.float32)
    return d_ids, d_am, q_ids, pix


def _p15_encode(flmr, mesh=None):
    """Phase 3's corpus encode (``encode_corpus``, batches of 128) on one
    process or over ``mesh``'s data axis."""
    from reranking_multimodal_retrievers_tpu_torch.engine import encode_corpus

    d_ids, d_am, _, _ = _p15_corpus()

    def doc_fn(batch):
        out = flmr.doc(batch[0].cuda(), batch[1].cuda())
        return out.late_interaction_output, out.context_mask

    batches = [(torch.as_tensor(d_ids[i:i + P15_ENC_BATCH]),
                torch.as_tensor(d_am[i:i + P15_ENC_BATCH]))
               for i in range(0, P15_ENC_DOCS, P15_ENC_BATCH)]
    return encode_corpus(doc_fn, batches, [str(i) for i in range(P15_ENC_DOCS)],
                         device="cuda", mesh=mesh)


def _p15_slab(s):
    """Docs ``[s, s + P15_SLAB)`` of 15c's index: unit vectors and masks of
    32 to 256 tokens from the slab's own seed; every 1,000th doc whole
    padding."""
    n = min(P15_SLAB, P15_DOCS - s)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1000 + s // P15_SLAB)
    emb = unit(gen, n, TRAIN_LD, P15_DIM)
    lens = torch.randint(TRAIN_LD // 8, TRAIN_LD + 1, (n,), device="cuda", generator=gen)
    mask = torch.arange(TRAIN_LD, device="cuda")[None, :] < lens[:, None]
    mask[(torch.arange(s, s + n, device="cuda") % 1000) == 7] = False
    return emb, mask


def _p15_index(lo, hi):
    """Rows ``[lo, hi)`` of 15c's index, drawn slab by slab."""
    emb = torch.empty(hi - lo, TRAIN_LD, P15_DIM, dtype=torch.bfloat16, device="cuda")
    mask = torch.empty(hi - lo, TRAIN_LD, dtype=torch.bool, device="cuda")
    for s in range((lo // P15_SLAB) * P15_SLAB, hi, P15_SLAB):
        e, m = _p15_slab(s)
        a, b = max(s, lo), min(s + e.shape[0], hi)
        emb[a - lo:b - lo], mask[a - lo:b - lo] = e[a - s:b - s], m[a - s:b - s]
    return emb, mask


def _p15_reranker():
    """Phase 4's monoPreFLMR-B reranker in bf16 from its own seed."""
    from reranking_multimodal_retrievers_tpu_torch.models import BertConfig
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import (
        FullContextRerankModel, RerankConfig)

    rcfg = RerankConfig(flmr=_p15_flmr_config(), cross_encoder=BertConfig(
        num_hidden_layers=1, max_position_embeddings=768, **P15_BERT_KW),
        loss_fn="BCE", max_query_length=P15_Q_TOKENS, max_decoder_source_length=P15_RERANK_L)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    return FullContextRerankModel(rcfg, device="cuda", dtype=torch.bfloat16,
                                  generator=gen).eval()


def _p15_rerank_inputs(candidates):
    """Phase 4's inputs for 15c's top-100: ``[8 * 100, 512]`` ids, mask and
    token types, and the 8 queries' pixels."""
    _, _, q_ids, pix = _p15_corpus()
    B, K, L, LQT = P15_QUERIES, P15_K, P15_RERANK_L, P15_Q_TOKENS
    ids = np.zeros((B * K, L), np.int64)
    am = np.zeros((B * K, L), np.int64)
    for i in range(B):
        for j, doc in enumerate(candidates[i]):
            drng = np.random.default_rng([SEED, int(doc)])
            n = int(drng.integers(L // 5, L - LQT + 1))
            ids[i * K + j, :LQT] = q_ids[i]
            ids[i * K + j, LQT:LQT + n] = drng.integers(1000, 29000, size=n)
            am[i * K + j, :LQT + n] = 1
    tt = np.zeros((B * K, L), np.int64)
    tt[:, LQT:] = 1
    return (torch.as_tensor(ids).cuda(), torch.as_tensor(am).cuda(), torch.as_tensor(tt).cuda(),
            torch.as_tensor(pix).cuda().to(torch.bfloat16))


def _p15_decoder(is_opt):
    """Phase 5's or 6's decoder reranker: bf16 on the card from the seed
    (T5's relative-position tables at std REL_BIAS_STD, as phase 5 draws
    them)."""
    from reranking_multimodal_retrievers_tpu_torch.models import OPTConfig, T5Config
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import Blip2DecoderRerankModel

    text = (OPTConfig.opt_2_7b(use_pallas_attention=True) if is_opt
            else T5Config.flan_t5_xl(use_pallas_attention=True, position_bias_bf16=True))
    cfg = _decoder_config(text, OPT_YES_NO if is_opt else T5_YES_NO)
    wgen = torch.Generator(device="cuda").manual_seed(SEED)
    model = Blip2DecoderRerankModel(cfg, device="cuda", dtype=torch.bfloat16,
                                    generator=wgen).eval()
    if not is_opt:
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("relative_attention_bias.weight"):
                    p.copy_(torch.randn(p.shape, device="cuda", generator=wgen) * REL_BIAS_STD)
    return model, text


def _p15_decoder_scores(is_opt, prompts, mesh=None):
    """p(yes) of the first ``prompts`` of phase 5's (T5) or 6's (OPT) 100,
    on one process or split over ``mesh`` (dp x tp), and the seconds of the
    call; with a mesh also K2's check at the rank's launch shape (its heads
    halved)."""
    from reranking_multimodal_retrievers_tpu_torch.engine import make_decoder_rerank_fn
    from reranking_multimodal_retrievers_tpu_torch.parallel import tp_shard_module

    model, text = _p15_decoder(is_opt)
    if mesh is not None:
        tp_shard_module(mesh, model)
        gc.collect()
        torch.cuda.empty_cache()
    ids, am, _, pix = _decoder_inputs(is_opt, 50000 if is_opt else 30000)
    chunk = 5 if is_opt else 10
    fn = make_decoder_rerank_fn(model, chunk_size=chunk, mesh=mesh)
    args = (ids[:prompts], am[:prompts], pix.to(torch.bfloat16))
    fn(*args)  # warm-up
    if mesh is not None:
        p_yes, seconds = _p15_wall(mesh, lambda: fn(*args))
    else:
        torch.cuda.synchronize()
        t = time.perf_counter()
        p_yes = fn(*args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
    q_rows = next(int(p.shape[0]) for n, p in model.named_parameters()
                  if n.endswith(("self_attn.q_proj.weight", "SelfAttention.q.weight")))
    del model, fn
    gc.collect()
    torch.cuda.empty_cache()
    return p_yes.float().cpu(), seconds, q_rows, text, chunk


def _p15_k2_local(is_opt, text, rows, n_model):
    """K2 at the rank's launch shape under the tensor-parallel split (``rows``
    prompts a launch): OPT's causal head_dim 80 or T5's bf16 head bias, at
    the heads a rank holds."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    Lp = DECODER_L + 32  # the prompt and the 32 query tokens
    H = (text.num_attention_heads if is_opt else text.num_heads) // n_model
    hd = text.head_dim if is_opt else text.d_kv
    q, k, v = (torch.randn(rows, Lp, H * hd, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    lens = torch.randint(Lp // 2, Lp + 1, (rows,), device="cuda", generator=gen)
    keep = torch.arange(Lp, device="cuda")[None, :] < lens[:, None]
    bias = torch.where(keep, 0.0, -1e9)
    if is_opt:
        causal = torch.ones(Lp, Lp, dtype=torch.bool, device="cuda").tril()
        return k2_variant(f"causal, head_dim 80, {H} local heads (OPT-2.7b, tp {n_model})",
                          q, k, v, bias, None, heads=H, scale=hd ** -0.5, causal=True,
                          sdpa_mask=causal[None, None] & keep[:, None, None, :],
                          flops=4 * rows * H * (Lp * (Lp + 1) // 2) * hd)
    head_bias = torch.randn(H, Lp, Lp, device="cuda", generator=gen).to(torch.bfloat16)
    q = q * 0.125
    return k2_variant(f"head_bias bf16, {H} local heads (Flan-T5-XL, tp {n_model})",
                      q, k, v, bias, head_bias, heads=H, scale=1.0, causal=False,
                      sdpa_mask=(bias[:, None, None, :] + head_bias[None].float()
                                 ).to(torch.bfloat16),
                      flops=4 * rows * H * Lp * Lp * hd)


def _p15_shard_kernels(Q, D, M, Dq, ds, timed):
    """K1 and K3 at the shard's launch shape (one launch over all its docs):
    the first P15_CHECK_DOCS docs' scores against the plain versions; with
    ``timed``, kernel and plain version (over the whole shard in blocks)
    timed. Returns (K1 row, K3 row)."""
    from reranking_multimodal_retrievers_tpu_torch.engine.search import quantize_queries
    from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_cuda import (
        maxsim_scores, maxsim_scores_reference)
    from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_int8_cuda import (
        maxsim_scores_int8, maxsim_scores_int8_reference)

    B, LQ, DIM = Q.shape
    N, LD, _ = D.shape
    c = P15_CHECK_DOCS
    Qq, qs = quantize_queries(Q.float())
    rows = {}
    for name, run, plain, args, tol, peak, nbytes in (
            ("K1", maxsim_scores, maxsim_scores_reference, (Q, D, M), K1_TOL, PEAK_BF16_FLOPS,
             Q.numel() * 2 + D.numel() * 2 + M.numel() + B * N * 4),
            ("K3", maxsim_scores_int8, maxsim_scores_int8_reference, (Qq, qs, Dq, ds, M), K3_TOL,
             PEAK_INT8_OPS, Qq.numel() + qs.numel() * 4 + Dq.numel() + ds.numel() * 4
             + M.numel() + B * N * 4)):
        got = run(*args)[:, :c]
        if name == "K1":
            ref = plain(Q, D[:c], M[:c])
        else:
            ref = plain(Qq, qs, Dq[:c], ds[:c], M[:c])
        valid = M[:c].any(dim=1)
        err = (got - ref)[:, valid].abs().max().item()
        check(err <= tol, f"15c {name} at the shard's shape: max |diff| {err} > {tol}")
        flops = 2 * B * LQ * N * LD * DIM
        b_ms, b_by = bound(flops, nbytes, peak)
        row = dict(shape=[[B, LQ, DIM], [N, LD, DIM]], max_abs_err=err, tol=tol,
                   checked_docs=c, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        if timed:
            def plain_all():
                for s in range(0, N, c):
                    if name == "K1":
                        plain(Q, D[s:s + c], M[s:s + c])
                    else:
                        plain(Qq, qs, Dq[s:s + c], ds[s:s + c], M[s:s + c])
            ms = cuda_ms(lambda: run(*args), 5)
            row.update(ms=ms, plain_ms=cuda_ms(plain_all, 1), share_of_bound=b_ms / ms)
        rows[name] = row
    return rows["K1"], rows["K3"]


def p15_rank(inp):
    """Phase 15 on one rank: 15a-15e over the process group the launcher
    made. Returns this rank's results (the large ones on rank 0 only)."""
    import torch.distributed as dist

    from reranking_multimodal_retrievers_tpu_torch.engine import (
        QuantizedTokenIndex, TokenIndex, make_chunked_rerank_fn)
    from reranking_multimodal_retrievers_tpu_torch.engine.search import (
        make_search_fn, make_search_fn_int8)
    from reranking_multimodal_retrievers_tpu_torch.models import bert as bert_mod
    from reranking_multimodal_retrievers_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    main_rank = rank == 0
    dp = make_mesh(n_data=P15_RANKS)
    tp = make_mesh(n_data=2, n_model=2)
    out = {"rank": rank, "device": str(dp.device), "launches": {}}

    # 15a. the FLMR train step at dp 4 and at dp 2 x tp 2
    reset_counts()
    a = {name: _p15_train(inp["batch"], mesh, inp["timed_steps"])
         for name, mesh in (("dp4", dp), ("dp2_tp2", tp))}
    out["launches"]["15a"] = read_counts()
    out["15a"] = a if main_rank else {
        k: {key: v[key] for key in ("metrics", "frozen_bitwise", "nan_skipped",
                                    "warm_step_seconds")}
        for k, v in a.items()}

    # 15b. the corpus encode over 4 ranks (K2)
    flmr = _p15_flmr_bf16()
    reset_counts()
    enc, enc_s = _p15_wall(dp, lambda: _p15_encode(flmr, dp))
    out["launches"]["15b"] = read_counts()
    out["15b"] = {"emb": enc.embeddings.cpu(), "mask": enc.mask.cpu(), "seconds": enc_s,
                  "num_padded_docs": enc.num_padded_docs}
    del flmr, enc
    gc.collect()
    torch.cuda.empty_cache()

    # 15c. the 100k index sharded over 4 ranks, bf16 (K1) and int8 (K3) search
    n_local = P15_DOCS // P15_RANKS
    lo = dp.data_index * n_local
    emb, mask = _p15_index(lo, lo + n_local)
    index = TokenIndex(embeddings=emb, mask=mask, doc_ids=[str(i) for i in range(P15_DOCS)],
                       mesh=dp)
    Q = inp["Q"].cuda()
    reset_counts()
    bf16_fn = make_search_fn(index.num_padded_docs, P15_K, mesh=dp)
    (vals, ids), search_s = _p15_wall(dp, lambda: bf16_fn(Q, *index.search_arrays))
    qindex = QuantizedTokenIndex.from_token_index(index)
    int8_fn = make_search_fn_int8(qindex.num_padded_docs, P15_K, mesh=dp)
    (qvals, qids), int8_s = _p15_wall(dp, lambda: int8_fn(Q.float(), *qindex.search_arrays))
    out["launches"]["15c"] = read_counts()
    best = {"bf16": [], "int8": []}
    for _ in range(3):  # the latency: the best of 3 more calls, between barriers
        best["bf16"].append(_p15_wall(dp, lambda: bf16_fn(Q, *index.search_arrays))[1])
        best["int8"].append(_p15_wall(
            dp, lambda: int8_fn(Q.float(), *qindex.search_arrays))[1])
    k1_row, k3_row = _p15_shard_kernels(Q, emb, mask, qindex.codes, qindex.scales, main_rank)
    out["15c"] = {"bf16": (vals.cpu(), ids.cpu()), "int8": (qvals.cpu(), qids.cpu()),
                  "first_seconds": [search_s, int8_s], "seconds": best,
                  "local_docs": int(emb.shape[0]), "k1": k1_row, "k3": k3_row}
    del emb, mask, index, qindex, bf16_fn, int8_fn
    gc.collect()
    torch.cuda.empty_cache()

    # 15d. phase 4's rerank with its rows over 4 ranks (K2)
    reranker = _p15_reranker()
    r_in = _p15_rerank_inputs(inp["candidates"])
    fn = make_chunked_rerank_fn(reranker, nway=P15_K, chunk_size=P15_K, mesh=dp)
    fn(*r_in)  # warm-up
    k2_in = {}
    reset_counts()
    with _Recorder() as rec:
        rec.patch(bert_mod, "fused_self_attention", _first_inputs(k2_in, _k2_bf16_key))
        logits, rerank_s = _p15_wall(dp, lambda: fn(*r_in))
    out["launches"]["15d"] = read_counts()
    out["15d"] = {"logits": logits.float().cpu(), "seconds": rerank_s,
                  "k2_calls": {key: e["calls"] for key, e in k2_in.items()}}
    if main_rank:
        out["15d"]["k2"] = {key: k2_bf16_line(e, f"key bias {list(key[0])}, sharded rerank "
                                                 "chunk (15d)") for key, e in k2_in.items()}
    del reranker, fn, r_in, k2_in
    gc.collect()
    torch.cuda.empty_cache()

    # 15e. the decoder rerankers at dp 2 x tp 2, one family at a time
    out["15e"] = {}
    for family, is_opt in (("blip2_opt_2_7b", True), ("blip2_flan_t5_xl", False)):
        reset_counts()
        p_yes, seconds, q_rows, text, chunk = _p15_decoder_scores(is_opt, inp["prompts"], tp)
        out["launches"][f"15e_{family}"] = read_counts()
        line = {"p_yes": p_yes, "seconds": seconds, "q_rows": q_rows}
        if main_rank:
            from reranking_multimodal_retrievers_tpu_torch.engine.rerank_eval import _pick_chunk

            rows, _ = _pick_chunk(inp["prompts"] // tp.n_data, chunk)
            line["k2"] = _p15_k2_local(is_opt, text, rows, tp.n_model)
        out["15e"][family] = line
    return out


def _p15_cli_rank(argv):
    """15f on one rank: ``cli.main`` with ``--n_devices 4`` inside the
    launcher's process group (as under ``torchrun``); returns the rank's
    launch counts, the seconds of each training step and index build, its
    K1 and fp32 K2 calls at each launch shape and, on rank 0, each
    shape's kernel row (checked and timed after the run, on the first
    inputs it got)."""
    import os

    import torch.distributed as dist

    from reranking_multimodal_retrievers_tpu_torch.cli.main import main as cli_main
    from reranking_multimodal_retrievers_tpu_torch.engine import search as search_mod
    from reranking_multimodal_retrievers_tpu_torch.executors import FLMRExecutor
    from reranking_multimodal_retrievers_tpu_torch.models import bert as bert_mod

    os.environ.pop("RMRT_PLATFORM", None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps, index, k1_in, k2_in = [], [], {}, {}
    reset_counts()
    with _Recorder() as rec:
        rec.patch(FLMRExecutor, "training_step", _clock(steps))
        rec.patch(FLMRExecutor, "build_index", _clock(index))
        rec.patch(search_mod, "maxsim_scores",
                  _first_inputs(k1_in, lambda Q, D, M=None, *r: (tuple(Q.shape), tuple(D.shape))))
        rec.patch(bert_mod, "fused_self_attention", _first_inputs(k2_in, _k2_key))
        rc = cli_main(argv)
    torch.cuda.synchronize()
    launches = read_counts()

    def name(key, kernel):
        return f"{'x'.join(map(str, key[0]))} per rank of {P15_RANKS} (15f {kernel})"

    rows = {"k1": [], "k2f32": []}
    if dist.get_rank() == 0:
        rows["k1"] = [{**k1_line(*e["args"][:3], name(key, "search")), "key": key}
                      for key, e in k1_in.items()]
        rows["k2f32"] = [{**k2f32_line(e, name(key, "encoders")), "key": key}
                         for key, e in k2_in.items()]
    return {"rc": rc, "launches": launches, "step_seconds": [t for t, _ in steps],
            "index_seconds": [t for t, _ in index], "rows": rows,
            "calls": {"k1": {k: e["calls"] for k, e in k1_in.items()},
                      "k2f32": {k: e["calls"] for k, e in k2_in.items()}}}


def p15_cli(smi, cards, backend):
    """15f: ``cli.main --n_devices 4`` over phase 11's synthetic data at full
    width (4 cards: one rank a card, NCCL); FLMR train 10 steps then test,
    the reranker's test over that dump; against one process. On fewer than
    4 cards: the overask error. Returns (line, launch counts, K1 and fp32 K2
    rows at its launch shapes)."""
    from reranking_multimodal_retrievers_tpu_torch.cli.main import main as cli_main
    from reranking_multimodal_retrievers_tpu_torch.parallel.launch import spawn

    t0 = time.perf_counter()
    global CLI_DIR
    if cards < P15_RANKS:
        try:
            cli_main(["--config", str(CONFIGS / FLMR_CONFIG), "--mode", "train",
                      "--n_devices", str(P15_RANKS)])
        except ValueError as e:
            check("devices" in str(e), f"15f: not the overask error: {e}")
            return {"phase": "p15f_cli", "card": smi, "cards": cards,
                    "overask_error": str(e),
                    "four_card_run": f"not made: {cards} card(s) on this machine",
                    "seconds": time.perf_counter() - t0}, {}, {"k1": [], "k2f32": []}
        check(False, "15f: --n_devices 4 on fewer cards did not raise")
    saved = CLI_DIR
    CLI_DIR = P15_CLI_DIR
    shutil.rmtree(P15_CLI_DIR, ignore_errors=True)
    try:
        def exp_dir(config, version):
            with open(CONFIGS / config) as f:
                name = json.load(f)["meta"]["experiment_name"]
            return P15_CLI_DIR / "experiments" / name / f"version_{version}"

        def argv(config, mode, *opts):
            return ["--config", str(CONFIGS / config), "--mode", mode, "--opts",
                    *_cli_opts(), *opts]

        steps = f"train.trainer_paras.limit_train_batches={P15_CLI_STEPS}"
        four_dir = exp_dir(FLMR_CONFIG, 1)
        rr_dir = exp_dir(RERANK_CONFIG, 0)
        runs, launches, clocks, rows = {}, {}, {}, {"k1": [], "k2f32": []}

        def ranks(name, args):
            t1 = time.perf_counter()
            res = spawn(_p15_cli_rank, P15_RANKS, (args + ["--n_devices", str(P15_RANKS)],),
                        device_type="cuda", timeout=P15_RANK_TIMEOUT)
            runs[name] = time.perf_counter() - t1
            check(all(r["rc"] == 0 for r in res), f"15f {name}: exit codes {res}")
            launches[f"15f_{name}"] = {k: sum(r["launches"][k] for r in res)
                                       for k in res[0]["launches"]}
            clocks[name] = res[0]
            for kind in ("k1", "k2f32"):  # each shape's launches over the ranks
                for row in res[0]["rows"][kind]:
                    key = row.pop("key")
                    rows[kind].append({**row, "launches": sum(r["calls"][kind].get(key, 0)
                                                              for r in res)})

        # one process's first step, then 4 ranks' training
        t1 = time.perf_counter()
        _cli(FLMR_CONFIG, "train", "train.trainer_paras.limit_train_batches=1")
        one_train = _metrics_lines(exp_dir(FLMR_CONFIG, 0))
        one_s = time.perf_counter() - t1
        ranks("train", argv(FLMR_CONFIG, "train", steps))
        # the test of the 4 ranks' checkpoint: its first batch on one
        # process, then all of it on 4 ranks (K1, fp32 K2)
        test_opts = (f"meta.experiment_dir='{four_dir}'",
                     "model_config.flmr.text_config.use_pallas_attention=true")
        t1 = time.perf_counter()
        _cli(FLMR_CONFIG, "test", *test_opts, "test.trainer_paras.limit_test_batches=1")
        one_dump = _dump(four_dir)
        one_s += time.perf_counter() - t1
        ranks("test", argv(FLMR_CONFIG, "test", *test_opts))
        ranks("rerank_test", argv(RERANK_CONFIG, "test",
                                  "model_config.cross_encoder.use_pallas_attention=true",
                                  "model_config.retrieve_result_path="
                                  f"'{four_dir / 'test_predictions_rank_0.json'}'"))
        one = (one_train, one_dump)
        four = (_metrics_lines(four_dir), _dump(four_dir))
        first = [m for m in four[0] if m.get("step") == 1 and "ib_loss" in m]
        want = [m for m in one[0] if m.get("step") == 1 and "ib_loss" in m][0]
        check(len(first) == 1, f"15f: {len(first)} first-step lines (rank 0 writes alone)")
        loss_err = max(loss_rel_err(first[0][k], want[k]) for k in ("loss", "ib_loss"))
        check(loss_err <= CLI_LOSS_TOL, f"15f first step {first[0]} vs one process {want}")
        worst = 0.0
        for got, ref in zip(four[1]["predictions"][:8], one[1]["predictions"][:8]):
            gv = np.array([[d["score"] for d in got["top_ranking_passages"]]])
            wv = np.array([[d["score"] for d in ref["top_ranking_passages"]]])
            gi = [[d["passage_id"] for d in got["top_ranking_passages"]]]
            wi = [[d["passage_id"] for d in ref["top_ranking_passages"]]]
            pos = {p: i for i, p in enumerate(sorted(set(gi[0]) | set(wi[0])))}
            worst = max(worst, same_top_k(gv, np.array([[pos[p] for p in gi[0]]]), wv,
                                          np.array([[pos[p] for p in wi[0]]]),
                                          atol=PLAID_ATOL, rtol=PLAID_RTOL))
        ckpts = sorted(p.name for p in (four_dir / "ckpts").iterdir())
        check(not exp_dir(FLMR_CONFIG, 2).exists(), "15f: a rank made its own experiment")
        rr_dump = _dump(rr_dir)
        check(len(rr_dump["predictions"]) == 500, "15f: the rerank dump")
        check(sum(launches["15f_train"].values()) == 0,
              f"15f training launched kernels: {launches['15f_train']}")
        check(launches["15f_test"]["K1"] > 0 and launches["15f_test"]["K2f32"] > 0
              and launches["15f_rerank_test"]["K2f32"] > 0, f"15f launches {launches}")
        steps_s = [m for m in four[0] if m.get("step") == P15_CLI_STEPS]
        return {"phase": "p15f_cli", "card": smi, "cards": cards, "backend": backend,
                "ranks": P15_RANKS, "one_process_seconds": one_s, "run_seconds": runs,
                "train_steps_per_s": _steps_per_s([(t, None) for t in
                                                   clocks["train"]["step_seconds"]]),
                "train_step_seconds_rank0": clocks["train"]["step_seconds"],
                "index_seconds_rank0": clocks["test"]["index_seconds"],
                "index_docs_per_s": 30_000 / sum(clocks["test"]["index_seconds"]),
                "first_step_rank0": {k: first[0][k] for k in ("loss", "ib_loss")},
                "first_step_one_process": {k: want[k] for k in ("loss", "ib_loss")},
                "first_step_rel_err": loss_err, "tol": CLI_LOSS_TOL,
                "top100_max_abs_err_first_8": worst, "checkpoints": ckpts,
                "train_logged_last_step": bool(steps_s), "launches": launches,
                "seconds": time.perf_counter() - t0}, launches, rows
    finally:
        CLI_DIR = saved
        shutil.rmtree(P15_CLI_DIR, ignore_errors=True)


def p15_phases(smi):
    """Phase 15: the one-process references on this card, then 15a-15e on
    4 ranks (one spawn), each held against its reference, then 15f.
    Returns (lines, kernel rows, launch counts of each part)."""
    from reranking_multimodal_retrievers_tpu_torch.parallel.launch import choose_backend, spawn

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    backend = choose_backend("cuda", P15_RANKS)
    layout = ("one rank a card" if backend == "nccl"
              else f"{P15_RANKS} ranks sharing {cards} card(s)")
    prompts = P15_PROMPTS[backend]
    lines = []

    # -- the one-process references
    t1 = time.perf_counter()
    batch = _p15_train_batch()
    ref_a = _p15_train(batch, timed_steps=P15_TIMED_STEPS[backend])
    flmr = _p15_flmr_bf16()
    ref_b = _p15_encode(flmr)
    _, _, q_ids, pix = _p15_corpus()
    with torch.inference_mode():
        Q = flmr.query(torch.as_tensor(q_ids).cuda(), torch.ones(q_ids.shape, dtype=torch.long,
                                                                 device="cuda"),
                       pixel_values=torch.as_tensor(pix).cuda().to(torch.bfloat16)
                       ).late_interaction_output
    del flmr
    from reranking_multimodal_retrievers_tpu_torch.engine import (
        QuantizedTokenIndex, TokenIndex, make_chunked_rerank_fn)
    from reranking_multimodal_retrievers_tpu_torch.engine.search import (
        make_search_fn, make_search_fn_int8)

    emb, mask = _p15_index(0, P15_DOCS)
    index = TokenIndex(embeddings=emb, mask=mask, doc_ids=[str(i) for i in range(P15_DOCS)])
    ref_c = {"bf16": make_search_fn(P15_DOCS, P15_K)(Q, emb, mask)}
    qindex = QuantizedTokenIndex.from_token_index(index)
    ref_c["int8"] = make_search_fn_int8(P15_DOCS, P15_K)(Q.float(), *qindex.search_arrays)
    one_search_ms = cuda_ms(lambda: make_search_fn(P15_DOCS, P15_K)(Q, emb, mask), 3)
    del emb, mask, index, qindex
    candidates = ref_c["bf16"][1].cpu().numpy()
    reranker = _p15_reranker()
    r_in = _p15_rerank_inputs(candidates)
    ref_d = make_chunked_rerank_fn(reranker, nway=P15_K, chunk_size=P15_K)(*r_in).float().cpu()
    del reranker, r_in
    gc.collect()
    torch.cuda.empty_cache()
    ref_e = {"blip2_opt_2_7b": _p15_decoder_scores(True, prompts),
             "blip2_flan_t5_xl": _p15_decoder_scores(False, prompts)}
    ref_s = time.perf_counter() - t1
    gc.collect()
    torch.cuda.empty_cache()

    # -- 15a-15e on 4 ranks
    t1 = time.perf_counter()
    res = spawn(p15_rank, P15_RANKS, ({"batch": batch, "Q": Q.cpu(), "candidates": candidates,
                                       "prompts": prompts,
                                       "timed_steps": P15_TIMED_STEPS[backend]},),
                device_type="cuda", timeout=P15_RANK_TIMEOUT)
    ranks_s = time.perf_counter() - t1
    r0 = res[0]
    parts = {k: {n: sum(r["launches"][k][n] for r in res) for n in r0["launches"][k]}
             for k in r0["launches"]}
    base = {"card": smi, "cards": cards, "backend": backend, "layout": layout,
            "ranks": P15_RANKS, "devices": [r["device"] for r in res]}
    info = "time-shares one card: times are information only" if backend == "gloo" else None

    # 15a
    check(sum(parts["15a"].values()) == 0, f"15a launched kernels: {parts['15a']}")
    lr = {"main": 1e-5, "mapping": 1e-4}
    a_line = {"phase": "p15a_train_flmr", **base, "global_batch": [TRAIN_B, TRAIN_NWAY, TRAIN_LD],
              "one_process_step_seconds": ref_a["step_seconds"],
              "one_process_warm_step_seconds": ref_a["warm_step_seconds"],
              "one_process_examples_per_s": (TRAIN_B / float(np.median(ref_a["warm_step_seconds"]))
                                             if ref_a["warm_step_seconds"] else None),
              "layouts": {}}
    for name in ("dp4", "dp2_tp2"):
        for r in res:
            got = r["15a"][name]
            errs = {k: loss_rel_err(got["metrics"][k], ref_a["metrics"][k])
                    for k in ("loss", "ib_loss")}
            check(max(errs.values()) <= TRAIN_LOSS_TOL,
                  f"15a {name} rank {r['rank']}: {got['metrics']} vs {ref_a['metrics']}")
            check(got["frozen_bitwise"], f"15a {name} rank {r['rank']}: the vision tower moved")
            check(got["nan_skipped"], f"15a {name} rank {r['rank']}: the NaN batch was taken")
        got = r0["15a"][name]
        leaves = {n: check_first_update(n, lr[ref_a["labels"][n]], ref_a["before"][n],
                                        got["after"][n], got["grads"][n], ref_a["after"][n],
                                        ref_a["grads"][n]) for n in FLMR_CHECKED_LEAVES}
        check(all(torch.equal(got["before"][n], ref_a["before"][n]) for n in FLMR_CHECKED_LEAVES),
              f"15a {name}: the ranks drew other weights")
        a_line["layouts"][name] = {
            "metrics_rank0": got["metrics"], "loss_rel_err": errs, "leaves": leaves,
            "cold_step_seconds": got["step_seconds"],
            "warm_step_seconds": got["warm_step_seconds"],
            "examples_per_s": (TRAIN_B / float(np.median(got["warm_step_seconds"]))
                               if got["warm_step_seconds"] else None),
            "query_weight_rows_rank0": got["local_query_rows"]}
    a_line.update(loss_tol=TRAIN_LOSS_TOL, grad_tol=TRAIN_GRAD_TOL, note=info,
                  launches=parts["15a"], nan_batch_skipped_by_every_rank=True,
                  vision_tower_bitwise=True)
    lines.append(a_line)

    # 15b
    check(parts["15b"]["K2"] > 0, f"15b launches {parts['15b']}")
    blocks = [(r["15b"]["emb"], r["15b"]["mask"]) for r in res]
    enc_emb = torch.cat([b[0] for b in blocks])[:P15_ENC_DOCS]
    enc_mask = torch.cat([b[1] for b in blocks])[:P15_ENC_DOCS]
    ref_emb, ref_mask = ref_b.embeddings.cpu(), ref_b.mask.cpu()
    enc_err = (enc_emb.float() - ref_emb.float()).abs().max().item()
    check(torch.equal(enc_mask, ref_mask) and enc_err <= P15_ENC_ATOL,
          f"15b: the sharded index off the one-process index by {enc_err}")
    lines.append({"phase": "p15b_encode_corpus", **base, "docs": P15_ENC_DOCS,
                  "docs_per_rank": int(blocks[0][0].shape[0]), "max_abs_err": enc_err,
                  "bitwise": torch.equal(enc_emb, ref_emb), "tol": P15_ENC_ATOL,
                  "seconds_4_ranks": r0["15b"]["seconds"],
                  "docs_per_s": P15_ENC_DOCS / r0["15b"]["seconds"], "note": info,
                  "launches": parts["15b"]})
    del ref_b, blocks

    # 15c
    check(parts["15c"]["K1"] > 0 and parts["15c"]["K3"] > 0, f"15c launches {parts['15c']}")
    c_line = {"phase": "p15c_sharded_search", **base, "index": [P15_DOCS, TRAIN_LD, P15_DIM],
              "docs_per_rank": r0["15c"]["local_docs"], "k": P15_K,
              "one_process_search_ms": one_search_ms}
    for kind, tol in (("bf16", K1_TOL), ("int8", K3_TOL)):
        want_v, want_i = (t.cpu().numpy() for t in ref_c[kind])
        err = 0.0
        for r in res:
            gv, gi = (t.numpy() for t in r["15c"][kind])
            check(np.array_equal(gi, res[0]["15c"][kind][1].numpy()),
                  f"15c {kind}: ranks disagree")
            err = max(err, same_top_k(gv, gi, want_v, want_i, atol=tol, rtol=0))
        c_line[f"{kind}_max_abs_err"] = err
        c_line[f"{kind}_identical_ids"] = int(np.array_equal(gi, want_i))
        c_line[f"{kind}_search_ms_best_of_3"] = min(r0["15c"]["seconds"][kind]) * 1e3
    c_line.update(first_call_seconds=r0["15c"]["first_seconds"], note=info,
                  launches=parts["15c"])
    lines.append(c_line)

    # 15d
    check(parts["15d"]["K2"] > 0, f"15d launches {parts['15d']}")
    d_err = max((r["15d"]["logits"] - ref_d).abs().max().item() for r in res)
    check(d_err <= P15_RERANK_ATOL, f"15d: sharded logits off the one-process logits by {d_err}")
    lines.append({"phase": "p15d_sharded_rerank", **base, "queries": P15_QUERIES,
                  "candidates": P15_K, "seq_len": P15_RERANK_L,
                  "rows_per_rank_per_chunk": P15_K // P15_RANKS,
                  "max_abs_err": d_err, "tol": P15_RERANK_ATOL,
                  "seconds": r0["15d"]["seconds"],
                  "candidates_per_s": P15_QUERIES * P15_K / r0["15d"]["seconds"], "note": info,
                  "launches": parts["15d"]})

    # 15e
    e_rows = []
    for family, (ref_p, ref_sec, full_rows, _, chunk) in ref_e.items():
        key = f"15e_{family}"
        check(parts[key]["K2"] > 0, f"{key} launches {parts[key]}")
        err = max((r["15e"][family]["p_yes"] - ref_p).abs().max().item() for r in res)
        check(err <= P_YES_TOL, f"{key}: p(yes) off the one-process scores by {err}")
        check(r0["15e"][family]["q_rows"] * 2 == full_rows, f"{key}: the q projection not split")
        k2 = r0["15e"][family]["k2"]
        emit({"phase": "kernel_check", "kernel": "K2 fused_self_attention", "card": smi, **k2})
        e_rows.append({**k2, "launches": parts[key]["K2"]})
        lines.append({"phase": f"p15e_{family}", **base, "mesh": "dp 2 x tp 2",
                      "prompts": prompts, "chunk_rows": chunk, "max_abs_err": err,
                      "tol": P_YES_TOL, "seconds": r0["15e"][family]["seconds"],
                      "one_process_seconds": ref_sec,
                      "candidates_per_s": prompts / r0["15e"][family]["seconds"],
                      "note": info, "launches": parts[key]})

    # 15f
    line, f_parts, f_rows = p15_cli(smi, cards, backend)
    lines.append(line)
    parts.update(f_parts)
    lines.append({"phase": "p15_ranks", **base, "references_seconds": ref_s,
                  "ranks_seconds": ranks_s, "seconds": time.perf_counter() - t0})
    rows = {"k1": [{**r0["15c"]["k1"], "launches": parts["15c"]["K1"],
                    "variant": f"per shard of {P15_RANKS} (15c)"}],
            "k3": [{**r0["15c"]["k3"], "launches": parts["15c"]["K3"],
                    "variant": f"per shard of {P15_RANKS} (15c)"}],
            # the calls at each shape, summed over the ranks
            "k2": [{**row, "launches": sum(r["15d"]["k2_calls"].get(key, 0) for r in res)}
                   for key, row in r0["15d"]["k2"].items()] + e_rows}
    rows["k1"] += f_rows["k1"]
    rows["k2f32"] = f_rows["k2f32"]
    return lines, rows, parts


def p15_kernel_rows(rows, parts):
    """Phase 15's rows of the ``kernels`` line: (each kernel's launches over
    phase 15's ranks, their counts summed; the rows of its launch shapes:
    K1 and K3 at the shard's, K2 at the sharded rerank's chunk and at the
    decoders' local heads, K1 and fp32 K2 at 15f's)."""
    csrc = "reranking_multimodal_retrievers_tpu_torch/csrc/"
    pallas = "reranking_multimodal_retrievers_tpu/ops/"
    k1 = dict(route="cuda", source=csrc + "maxsim.cu", replaces=pallas + "maxsim_pallas.py:67")
    k3 = dict(route="cuda", source=csrc + "maxsim_int8.cu",
              replaces=pallas + "maxsim_pallas.py:183")
    k2 = dict(route="cuda", source=csrc + "attention.cu",
              replaces=pallas + "attention_pallas.py:95")
    k2f32 = dict(k2, source=csrc + "attention_f32.cu")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def total(name):
        return sum(p[name] for p in parts.values())

    totals = [dict(name=f"{fn} (phase 15)", launches=total(counter), **where,
                   **{k: rows[key][0][k] for k in keys})
              for fn, counter, where, key in (
                  ("maxsim_scores", "K1", k1, "k1"), ("maxsim_scores_int8", "K3", k3, "k3"),
                  ("fused_self_attention", "K2", k2, "k2"),
                  ("fused_self_attention fp32", "K2f32", k2f32, "k2f32"))
              if rows[key]]
    per_shape = [dict(name=f"{fn} {r['variant']}", **where, **r)
                 for fn, where, key in (
                     ("maxsim_scores", k1, "k1"), ("maxsim_scores_int8", k3, "k3"),
                     ("fused_self_attention", k2, "k2"),
                     ("fused_self_attention fp32", k2f32, "k2f32"))
                 for r in rows[key]]
    return totals, per_shape


# ---- phase 16: PreFLMR-G as published (configs/evqa_flmr_G.json) fine-tuned
# ---- and tested from cli.main over the committed M2KR snapshot

P16_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_p16"
P16_CONFIG = "evqa_flmr_G.json"
P16_STEPS = 20  # train.trainer_paras.limit_train_batches: 20 of the epoch's 256 steps
# the update recomputed from AdamW's state: the third step, the first at
# the full learning rates after the config's 2 warm-up steps
P16_CHECKED_STEP = 2
# the first step's losses on the card (fp32, TF32 off in cuBLAS and cuDNN)
# against the CPU in fp32 on the same weights and batch: round-off through
# ViT-G's 48 layers, BERT-base's 12 and the mapping network into scores that
# sum 320 maxima of unit rows (up to ~320); a share of max(1, |loss|)
P16_LOSS_TOL = 1e-4
# the checked step's update against AdamW's formula at its group's own lr,
# beyond one fp32 spacing of the weight, as a share of that lr: fp32
# round-off in m / (sqrt(v) + eps) of order 1; the other group's lr (10x
# apart) would miss by ~9 lr
P16_UPDATE_TOL = 1e-3
# the top-100 of the first 8 test queries, K1 at k = 100 over the test's
# index against the plain search (the dump holds the config's top-10)
P16_TOP_K = 100


def _plain_dpr_metrics(preds, Ks):
    """``compute_DPR_scores`` and ``compute_DPR_scores_with_pos_ids`` of a
    prediction dump, written out here where the JAX package is not imported
    (``tests/test_torch_preflmr_cli.py`` holds this function and the port's
    processor against the JAX package's): pseudo-relevance recall and
    precision by answer containment, and the same by positive passage ids,
    at each K."""
    out = {}
    sums = {k: [0.0] * len(Ks) for k in ("precision", "recall", "gold_precision",
                                         "gold_recall", "pos_item_ids_precision",
                                         "pos_item_ids_recall")}
    for p in preds:
        top = p["top_ranking_passages"]
        for i, K in enumerate(Ks):
            texts = [d["content"].lower() for d in top[:K]]
            found = sum(any(a.lower() in t for a in p["answers"]) for t in texts)
            gold = p.get("gold_answer", "")
            found_gold = sum(bool(gold) and gold.lower() in t for t in texts)
            sums["recall"][i] += found > 0
            sums["precision"][i] += found / K
            sums["gold_recall"][i] += found_gold > 0
            sums["gold_precision"][i] += found_gold / K
    for p in preds:
        hits = [d["passage_id"] in p["pos_item_ids"] for d in p["top_ranking_passages"]]
        for i, K in enumerate(Ks):
            sums["pos_item_ids_recall"][i] += sum(hits[:K]) > 0
            sums["pos_item_ids_precision"][i] += sum(hits[:K]) / K
    for name, vals in sums.items():
        for i, K in enumerate(Ks):
            out[f"{name}_at_{K}"] = float(vals[i] / len(preds))
    return out


def _p16_step_probe(store):
    """A ``training_step`` wrapper: at the first call it keeps the executor,
    the batch and the model's initial state on the host; at
    P16_CHECKED_STEP it recomputes every trained parameter's update from
    AdamW's state after the step at the lr its group should have (the
    config's ``lr`` for ``main``, ``mapping_network_lr`` for ``mapping``)."""
    import math

    def make(orig):
        def step(self, batch):
            i = store.get("calls", 0)
            store["calls"] = i + 1
            if i == 0:
                store.update(ex=self, batch=batch, init={
                    k: v.detach().to("cpu", copy=True) for k, v in self.model.state_dict().items()})
            if i != P16_CHECKED_STEP:
                return orig(self, batch)
            opt = self._train_state.optimizer
            before = {id(p): p.detach().clone() for g in opt.param_groups for p in g["params"]}
            lrs = {g["name"]: g["lr"] for g in opt.param_groups}  # this step's
            out = orig(self, batch)
            errs = {}
            for g in opt.param_groups:
                lr, (b1, b2) = lrs[g["name"]], g["betas"]
                worst = 0.0
                for p in g["params"]:
                    st = opt.state[p]
                    t = float(st["step"])
                    denom = st["exp_avg_sq"].sqrt() / math.sqrt(1 - b2 ** t) + g["eps"]
                    want = (before[id(p)] * (1 - lr * g["weight_decay"])
                            - lr / (1 - b1 ** t) * st["exp_avg"] / denom)
                    # beyond one fp32 spacing of the weight (LayerNorm's ~1)
                    gap = (p.detach() - want).abs() - want.abs() * 2 ** -23
                    worst = max(worst, gap.max().item())
                errs[g["name"]] = worst / lr
            names = {id(p): n for n, p in self.model.named_parameters()}
            store["step_check"] = {
                "step": i + 1, "lr": lrs, "update_err_over_lr": errs, "tol": P16_UPDATE_TOL,
                "params": {g["name"]: len(g["params"]) for g in opt.param_groups},
                "mapping_names": sorted({names[id(p)].split(".")[0] for g in opt.param_groups
                                         if g["name"] == "mapping" for p in g["params"]})}
            return out
        return step
    return make


def p16_phase(smi):
    """Phase 16: ``configs/evqa_flmr_G.json`` (PreFLMR-G: BERT-base,
    ViT-G/14 48 x 1664 at 224, dim 128, a 32-token prefix, the 1-layer
    mapping network cross-attending to 32 text rows; the vision encoders
    frozen, the mapping group at its own lr, the clip at 1.0) from
    ``cli.main`` in fp32 over ``tests/fixtures/m2kr_snapshot``. Changed
    from the file: the M2KR node's paths (and its images), the tokenizers'
    vocabulary (the snapshot's words), the experiment and cache dirs and
    ``limit_train_batches`` (20). ``--mode train`` runs 20 steps at batch 4
    with 1 negative and validation as the config has it (2 batches over
    all 8,192 passages); its first step's losses are held against the CPU
    in fp32 on the same weights and batch, the third step's update of
    every trained parameter against AdamW's at its group's lr, and every
    ``vision_encoder`` weight after the run bitwise against the start.
    ``--mode test`` from the checkpoint with ``use_pallas_attention`` in
    the text encoder: 256 queries over all 8,192 passages (K1 at [4, 320,
    128] x [8192, 64, 128]; fp32 K2 at the doc and query encoders'
    shapes), each kernel against its plain version on its first inputs
    at each launch shape, the first 8 queries' top-10 (the dump's) and
    top-100 against the plain search, the dump's metrics against
    :func:`_plain_dpr_metrics`. Under ``build/chip_smoke_p16/``, removed
    after. Returns (lines, K1 row, fp32 K2 rows, launch counts)."""
    import os

    from reranking_multimodal_retrievers_tpu_torch.data.ops.m2kr_ops import _load_hf
    from reranking_multimodal_retrievers_tpu_torch.engine import Searcher
    from reranking_multimodal_retrievers_tpu_torch.executors import FLMRExecutor
    from reranking_multimodal_retrievers_tpu_torch.executors import flmr_executor
    from reranking_multimodal_retrievers_tpu_torch.models import FLMRModelForRetrieval
    from reranking_multimodal_retrievers_tpu_torch.models.tokenization import write_test_vocab

    t0 = time.perf_counter()
    os.environ.pop("RMRT_PLATFORM", None)  # the CLI runs on the card
    if P16_DIR.exists():
        shutil.rmtree(P16_DIR)
    base = json.loads((CONFIGS / P16_CONFIG).read_text())
    try:
        tables = {**_load_hf(f"{P13D_SNAPSHOT}///EVQA_data"),
                  **_load_hf(f"{P13D_SNAPSHOT}///EVQA_passages")}
        sizes = {k: len(v) for k, v in tables.items()}
        write_test_vocab(str(P16_DIR / "vocab_snapshot" / "vocab.txt"), _table_words(tables))
        del tables
        cfg = _p13d_config(base, "16", root=P16_DIR, snapshot=P13D_SNAPSHOT,
                           images=P13D_IMAGES)
        exp = Path(cfg["meta"]["EXPERIMENT_FOLDER"]) / cfg["meta"]["experiment_name"] / "version_0"
        store, keep, draws, inits, saves, loads = {}, {}, [], [], [], []
        with _Recorder() as rec:
            rec.patch(FLMRExecutor, "training_step", _p16_step_probe(store))
            rec.patch(flmr_executor, "FLMRModelForRetrieval", _clock(draws))
            rec.patch(FLMRExecutor, "_init_model", _clock(inits))
            rec.patch(FLMRExecutor, "save_checkpoint", _clock(saves))
            rec.patch(FLMRExecutor, "load_checkpoint", _clock(loads))
            lines, k1_row, _, k2_rows, parts = p13_train_test(
                smi, cfg, "16", sizes["train"], sizes["test"],
                "the parquet snapshot's 8,192 passages", steps=P16_STEPS, int8=False,
                validate=True, keep=keep)
        # validation searches by K1 at the test's launch shape: its launches join the row
        k1_row.update(launches=k1_row["launches"] + parts["16_train"]["K1"],
                      launches_in_validation=parts["16_train"]["K1"])
        ex = store.pop("ex")
        model = ex.model
        n_params = sum(p.numel() for p in model.parameters())
        tower = sum(p.numel() for n, p in model.named_parameters() if "vision_encoder" in n)

        # the first step on the CPU in fp32: the same initial weights and batch
        t1 = time.perf_counter()
        card = [m for m in _metrics_lines(exp) if m.get("step") == 1 and "ib_loss" in m][0]
        cpu = FLMRModelForRetrieval(ex.flmr_config, device="meta")
        cpu.load_state_dict(store["init"], assign=True)
        batch = {k: v.cpu() for k, v in ex.model_batch(store.pop("batch")).items()}
        with torch.no_grad():
            out = cpu.train()(**batch, num_negative_examples=ex.num_negative_samples)
        want = {"loss": float(out.loss), "ib_loss": float(out.in_batch_negative_loss)}
        del cpu, out, batch
        cpu_s = time.perf_counter() - t1
        loss_err = max(abs(card[k] - v) / max(1.0, abs(v)) for k, v in want.items())
        check(loss_err <= P16_LOSS_TOL, f"16 first step: card {card} vs CPU fp32 {want}")
        # the vision encoders bitwise as they started; the update of every
        # trained parameter at its group's lr
        init = store.pop("init")
        frozen = [n for n, p in model.named_parameters() if "vision_encoder" in n]
        moved = [n for n in frozen if not torch.equal(model.get_parameter(n).detach().cpu(),
                                                      init[n])]
        check(frozen and not moved, f"16: vision_encoder weights moved in training: {moved[:4]}")
        check(all(model.get_parameter(n).requires_grad for n in frozen),
              "16: a frozen weight lost requires_grad (its gradient would leave the clip's norm)")
        step = store["step_check"]
        opt_cfg = base["train"]["optimizer_config"]
        check(step["lr"] == {"main": opt_cfg["optimizer_params"]["lr"],
                             "mapping": opt_cfg["mapping_network_lr"]}
              and max(step["update_err_over_lr"].values()) <= P16_UPDATE_TOL,
              f"16: the groups' update at step {step['step']}: {step}")
        del ex, model, init, store
        gc.collect()
        torch.cuda.empty_cache()

        # the test's rankings against the plain search, its metrics recomputed
        index, dump, Q8 = keep["index"], keep["dump"], keep["queries"]
        preds = dump["predictions"]
        top10_err = top_k_vs_plain(Q8.to(torch.bfloat16), index,
                                   [p["top_ranking_passages"] for p in preds[:8]])
        ids, vals = Searcher(index, k=P16_TOP_K).search(Q8)
        top100_err = top_k_vs_plain(Q8.to(torch.bfloat16), index, [
            [{"passage_id": d, "score": float(v)} for d, v in zip(row, vrow)]
            for row, vrow in zip(ids, vals)])
        check(max(top10_err, top100_err) <= K1_TOL,
              f"16 top-10 / top-100 off the plain search by {top10_err} / {top100_err}")
        Ks = base["model_config"]["Ks"]
        plain_m = _plain_dpr_metrics(preds, Ks)
        check(dump["metrics"] == plain_m, f"16: the dump's metrics {dump['metrics']} against "
              f"the plain recomputation {plain_m}")
        del index, Q8, keep
        train_line, test_line = lines
        lines.append({
            "phase": "p16_preflmr_g", "config": P16_CONFIG, "card": smi, "params": n_params,
            "vision_tower_params": tower, "host_draw_seconds": [t for t, _ in draws],
            "executor_init_seconds": [t for t, _ in inits],
            "first_step_card": {k: card[k] for k in want}, "first_step_cpu_fp32": want,
            "first_step_rel_err": loss_err, "tol": P16_LOSS_TOL, "cpu_check_seconds": cpu_s,
            "vision_encoder_weights_bitwise": len(frozen), "step_check": step,
            "checkpoint_bytes": _dir_bytes(exp / "ckpts"),
            "checkpoint_write_seconds": [t for t, _ in saves],
            "checkpoint_load_seconds": [t for t, _ in loads],
            "test_top10_vs_plain_max_abs_err": top10_err,
            f"test_top{P16_TOP_K}_vs_plain_max_abs_err": top100_err, "top_k_tol": K1_TOL,
            "metrics_equal_plain_recomputation": True,
            **{k: v for k, v in dump["metrics"].items() if "recall" in k},
            "train_wall_seconds": train_line["seconds"], "test_wall_seconds": test_line["seconds"],
            "seconds": time.perf_counter() - t0})
    finally:
        if P16_DIR.exists():
            shutil.rmtree(P16_DIR)
    return lines, k1_row, k2_rows, parts


# ---- phases 3e, 4c, 5b and 6b: the published retrievers' larger scales,
# monoPreFLMR-L, and the W8A8 decoder rerankers
P3E_SCALES = ("L", "G")  # configs/okvqa_flmr_{L,G}.json
# 3e's top-100 (bf16 weights, K1 and K2) against an fp32 copy of the same
# weights without the kernels: each total sums 320 query tokens' maxima of
# unit-vector products; bf16 keeps 8 mantissa bits (0.4% a rounding), and
# 12 BERT layers, the ViT and the mapping network carry that into each
# token's rows, so a total moves by well under 1% of itself; ranks may swap
# only between docs within that tolerance
P3E_TOPK_RTOL = 0.01
# one PreFLMR-L query's rows, the card's fp32 copy (TF32 off in cuBLAS and
# cuDNN) against the CPU in fp32: round-off through 12 + 24 + 1 layers of
# unit-norm output rows
P3E_CPU_TOL = 1e-4
# 4c: bench.py's L model (:88-118): the cross-encoder's position table
# sized past the 800-row joint sequence
P4C_MAX_POSITIONS = 1024


def _preflmr_config(scale, **bert_kw):
    """FLMRConfig from ``configs/okvqa_flmr_{scale}.json``'s
    ``model_config.flmr`` block, the BERT serving knobs ``bert_kw`` added."""
    from reranking_multimodal_retrievers_tpu_torch.models import (
        BertConfig, CLIPVisionConfig, FLMRConfig)

    fc = dict(json.loads((CONFIGS / f"okvqa_flmr_{scale}.json").read_text())
              ["model_config"]["flmr"])
    return FLMRConfig(text_config=BertConfig(**fc.pop("text_config"), **bert_kw),
                      vision_config=CLIPVisionConfig(**fc.pop("vision_config")), **fc)


def p3e_preflmr(scale, index, corpus, queries, bert_kw, smi):
    """Phase 3e: PreFLMR-``scale`` (``_preflmr_config``; BERT-base, ViT-L/14
    or ViT-G/14 at 224, dim 128, 32-token prefix, the 1-layer mapping
    network), bf16 weights drawn on the card from the seed, encodes phase
    3's 1,024 docs into a copy of phase 3's 100,000-doc index (the same
    padding docs) and its 8 queries, and serves them through
    RetrievalService, k = 100 (K2 in the BERT encoders, K1 over the slabs).
    The top-100 is held against an fp32 copy of the weights without the
    kernels (``same_top_k``, P3E_TOPK_RTOL); for L, one query's fp32 rows
    against the CPU. K1 and K2 against their plain versions on the first
    inputs 3e gave them at each launch shape. Returns (the line, K1's rows,
    K2's rows); frees its models."""
    from reranking_multimodal_retrievers_tpu_torch.engine import (
        TokenIndex, encode_corpus, make_search_fn)
    from reranking_multimodal_retrievers_tpu_torch.engine import search as search_mod
    from reranking_multimodal_retrievers_tpu_torch.models import FLMRModelForRetrieval
    from reranking_multimodal_retrievers_tpu_torch.models import bert as bert_mod
    from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_cuda import (
        maxsim_scores_reference)
    from reranking_multimodal_retrievers_tpu_torch.serving import RetrievalService

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    fcfg = _preflmr_config(scale, **bert_kw)
    flmr = FLMRModelForRetrieval(fcfg, device="cuda", dtype=torch.bfloat16,
                                 generator=torch.Generator(device="cuda").manual_seed(SEED)).eval()
    tower = sum(p.numel() for p in flmr.context_vision_encoder.parameters())
    n_params = sum(p.numel() for p in flmr.parameters())
    batches, names = corpus
    q_ids, q_am, pix = queries
    BQ, K = q_ids.shape[0], 100
    n_enc, n_all = len(names), index.num_padded_docs

    def doc_fn(batch):
        out = flmr.doc(batch[0].cuda(), batch[1].cuda())
        return out.late_interaction_output, out.context_mask

    def query(model, dtype):
        with torch.inference_mode():
            return model.query(q_ids.cuda(), q_am.cuda(),
                               pixel_values=pix.cuda().to(dtype)).late_interaction_output

    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    k1_in, k2_in = {}, {}
    reset_counts()
    with _Recorder() as rec:
        rec.patch(search_mod, "maxsim_scores",
                  _first_inputs(k1_in, lambda Q, D, M=None, *r: (tuple(Q.shape),
                                                                 tuple(D.shape))))
        rec.patch(bert_mod, "fused_self_attention", _first_inputs(k2_in, _k2_bf16_key))
        t1 = time.perf_counter()
        enc = encode_corpus(doc_fn, batches, names, device="cuda")
        emb, mask = index.embeddings.clone(), index.mask.clone()
        emb[:n_enc], mask[:n_enc] = enc.embeddings, enc.mask
        del enc
        idx = TokenIndex(embeddings=emb, mask=mask, doc_ids=list(index.doc_ids))
        Qm = query(flmr, torch.bfloat16)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t1
        svc = RetrievalService(make_search_fn(n_all, k=K), idx, batch_queries=BQ, max_wait_ms=50)
        try:
            t1 = time.perf_counter()
            results = [f.result(timeout=600) for f in [svc.search(Qm[i]) for i in range(BQ)]]
            search_s = time.perf_counter() - t1
        finally:
            svc.close()
    torch.cuda.synchronize()
    launches = read_counts()
    layers = fcfg.text_config.num_hidden_layers
    want_k2 = layers * (len(batches) + 1)  # each doc batch and the query batch
    check(launches["K1"] > 0 and launches["K2"] == want_k2
          and launches["K3"] == launches["K2f32"] == 0,
          f"3e {scale} launches {launches}, want K2 = {want_k2}")
    vc = fcfg.vision_config  # text, prefix and patch rows
    LQ = q_ids.shape[1] + fcfg.mapping_network_prefix_length + (
        vc.image_size // vc.patch_size) ** 2
    check(tuple(Qm.shape) == (BQ, LQ, 128) and bool(torch.isfinite(Qm.float()).all()),
          f"3e {scale} query rows {tuple(Qm.shape)}, want {LQ}")
    check(all(len(ids) == K and np.isfinite(v).all() for ids, v in results),
          f"3e {scale} results")
    got_vals = np.stack([v for _, v in results]).astype(np.float32)
    got_ids = np.asarray([[int(d) for d in ids] for ids, _ in results])

    # the kernels at 3e's launch shapes (not the main path's launches)
    k1_rows = [dict(k1_line(*e["args"][:3], f"3e PreFLMR-{scale} queries "
                            f"{'x'.join(map(str, qs))} over a {ds[0]}-doc slab"),
                    launches=e["calls"])
               for (qs, ds), e in k1_in.items()]
    k2_rows = [k2_bf16_line(e, f"key bias {'x'.join(map(str, shape))} "
                               f"(3e PreFLMR-{scale} BERT encoders)")
               for (shape, _), e in k2_in.items()]
    check(sum(r["launches"] for r in k1_rows) == launches["K1"]
          and sum(r["launches"] for r in k2_rows) == launches["K2"],
          f"3e {scale}: K1 or K2 launches at shapes not recorded")
    del k1_in, k2_in
    query_ms = cuda_ms(lambda: query(flmr, torch.bfloat16), 3)
    search_ms = cuda_ms(lambda: make_search_fn(n_all, k=K)(Qm, emb, mask), 3)

    def top_k(Q, docs):
        """The top-K of ``Q`` over ``docs`` (the first n_enc docs, fp32 or
        bf16) and the rest of the index, by the plain score in fp32."""
        with torch.inference_mode():
            scores = torch.cat([maxsim_scores_reference(Q, docs, mask[:n_enc]),
                                maxsim_scores_reference(Q, emb[n_enc:], mask[n_enc:])], dim=1)
            vals, ids = torch.topk(scores, K, dim=1)
        return vals.cpu().numpy(), ids.cpu().numpy()

    def plain_docs(model, dtype):
        with torch.inference_mode():
            return torch.cat([model.doc(b[0].cuda(), b[1].cuda()).late_interaction_output
                              for b in batches])[:n_enc].to(dtype)

    # the same weights in fp32 without the kernels (the check) and, sharing
    # the bf16 tensors, in bf16 without them (information: the kernels'
    # share of the gap)
    t1 = time.perf_counter()
    flmr32 = _plain_twin(flmr, torch.float32)
    Q32 = query(flmr32, torch.float32)
    want_vals, want_ids = top_k(Q32, plain_docs(flmr32, torch.float32))
    err = same_top_k(got_vals, got_ids, want_vals, want_ids, 0.0, P3E_TOPK_RTOL)
    plain = _plain_twin(flmr)
    pv, pi = top_k(query(plain, torch.bfloat16), plain_docs(plain, torch.bfloat16))
    del plain
    cpu_err = None
    if scale == "L":  # one query's rows, card fp32 against CPU fp32
        cpu = FLMRModelForRetrieval(flmr32.config, device="meta")
        cpu.load_state_dict({k: v.cpu() for k, v in flmr32.state_dict().items()}, assign=True)
        with torch.inference_mode():
            want_q = cpu.eval().query(q_ids[:1], q_am[:1],
                                      pixel_values=pix[:1].float()).late_interaction_output
        cpu_err = (Q32[:1].cpu() - want_q).abs().max().item()
        check(cpu_err <= P3E_CPU_TOL, f"3e {scale}: fp32 query rows card vs CPU {cpu_err}")
        del cpu
    check_s = time.perf_counter() - t1

    def ranks_equal(a, b):
        return int(sum(np.array_equal(x, y) for x, y in zip(a, b)))

    line = {"phase": f"retrieve_preflmr_{scale}", "card": smi, "params": n_params,
            "vision_tower_params": tower, "vision_tower_gb_bf16": tower * 2 / 1e9,
            "vision": dataclasses.asdict(fcfg.vision_config), "query_rows": LQ,
            "index": [n_all, emb.shape[1], 128], "queries": BQ, "k": K,
            "setup_seconds": setup_s, "encode_seconds": encode_s, "search_seconds": search_s,
            "query_encode_ms_8": query_ms, "search_ms": search_ms,
            "top100_max_abs_err_vs_fp32": err, "top100_rtol": P3E_TOPK_RTOL,
            "top100_identical_vs_fp32": ranks_equal(got_ids, want_ids),
            "top100_same_sets_vs_fp32": int(sum(set(a) == set(b)
                                                for a, b in zip(got_ids, want_ids))),
            "top100_max_abs_err_bf16_without_kernels_vs_fp32":
                float(np.abs(pv - want_vals).max()),
            "top100_identical_bf16_without_kernels_vs_fp32": ranks_equal(pi, want_ids),
            "score_range_top100": [float(want_vals[:, -1].min()), float(want_vals[:, 0].max())],
            "fp32_query_rows_card_vs_cpu": cpu_err, "cpu_tol": P3E_CPU_TOL,
            "check_seconds": check_s, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "k1_shapes": {r["variant"]: r["launches"] for r in k1_rows},
            "k2_shapes": {r["variant"]: r["launches"] for r in k2_rows},
            "launches": launches, "seconds": time.perf_counter() - t0}
    del flmr, flmr32, idx, emb, mask, Qm, Q32
    gc.collect()
    torch.cuda.empty_cache()
    return line, k1_rows, k2_rows


def p4c_rerank_l(fcfg_l, inputs, bert_kw, smi):
    """Phase 4c: monoPreFLMR-L (``bench.py:88-118``: 3e's PreFLMR-L and a
    1-layer cross-encoder with a 1,024-row position table) in bf16 from the
    seed, phase 4's 8 queries x 100 candidates x 512 tokens and images
    through RerankService in chunks of 100: K2 at [100, 512, 12 x 64] in the
    12 text layers and at [100, 800, 12 x 64] in the cross-encoder (512
    text + 32 prefix + 256 patch rows), 104 launches a batch. Four logits
    against the CPU in fp32; K2 against its plain version at each launch
    shape on the first inputs (the first query's key mask), timed beside
    ``scaled_dot_product_attention``. Returns (the line, K2's rows); frees
    its models."""
    from reranking_multimodal_retrievers_tpu_torch.engine import make_chunked_rerank_fn
    from reranking_multimodal_retrievers_tpu_torch.models import BertConfig
    from reranking_multimodal_retrievers_tpu_torch.models import bert as bert_mod
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import (
        FullContextRerankModel, RerankConfig)
    from reranking_multimodal_retrievers_tpu_torch.serving import RerankService

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ids, am, tt, pix = inputs
    BQ, K, L = ids.shape
    rcfg = RerankConfig(flmr=fcfg_l, cross_encoder=BertConfig(
        num_hidden_layers=1, max_position_embeddings=P4C_MAX_POSITIONS, **bert_kw),
        loss_fn="BCE", max_query_length=32, max_decoder_source_length=L)
    reranker = FullContextRerankModel(rcfg, device="cuda", dtype=torch.bfloat16,
                                      generator=torch.Generator(device="cuda").manual_seed(SEED)
                                      ).eval()
    joint = []
    hook = reranker.reranker.register_forward_pre_hook(
        lambda m, args: joint.append(args[0].shape[1]))
    rsvc = RerankService(make_chunked_rerank_fn(reranker, nway=K, chunk_size=100), nway=K,
                         max_batch=BQ, max_wait_ms=50, device="cuda")
    k2_in = {}
    reset_counts()
    try:
        with _Recorder() as rec:
            rec.patch(bert_mod, "fused_self_attention", _first_inputs(k2_in, _k2_bf16_key))
            batch_s = []
            for _ in range(2):  # the first batch also warms up cuBLAS
                t1 = time.perf_counter()
                futs = [rsvc.rerank(ids[i], am[i], tt, pix[i]) for i in range(BQ)]
                logits = np.stack([f.result(timeout=600) for f in futs])
                batch_s.append(time.perf_counter() - t1)
    finally:
        hook.remove()
        rsvc.close()
    torch.cuda.synchronize()
    launches = read_counts()
    n_chunks = BQ * K // 100
    Lj = L + fcfg_l.mapping_network_prefix_length + (
        fcfg_l.vision_config.image_size // fcfg_l.vision_config.patch_size) ** 2
    want_k2 = 2 * n_chunks * (fcfg_l.text_config.num_hidden_layers + 1)
    check(set(joint) == {Lj} and len(joint) == 2 * n_chunks,
          f"4c joint rows {sorted(set(joint))}, want {Lj}")
    check(launches["K2"] == want_k2 and launches["K1"] == launches["K3"] == launches["K2f32"] == 0,
          f"4c launches {launches}, want K2 = {want_k2}")
    check(logits.shape == (BQ, K) and bool(np.isfinite(logits).all()), f"4c logits {logits.shape}")
    k2_rows = [k2_bf16_line(e, f"key bias {'x'.join(map(str, shape))} (4c monoPreFLMR-L "
                               f"{'cross-encoder' if shape[1] == Lj else 'text encoder'})")
               for (shape, _), e in k2_in.items()]
    check(sum(r["launches"] for r in k2_rows) == launches["K2"], "4c: K2 launches not recorded")
    del k2_in
    # the ViT-L/14 prefix once a query image, as the chunked program runs it
    with torch.inference_mode():
        pix8 = torch.as_tensor(pix).cuda().to(torch.bfloat16)
        vit_ms = cuda_ms(lambda: reranker.encode_vision(pix8), 3)

    t1 = time.perf_counter()
    cpu_model = FullContextRerankModel(rcfg, device="meta")
    cpu_model.load_state_dict({k: v.float().cpu() for k, v in reranker.state_dict().items()},
                              assign=True)
    want = make_chunked_rerank_fn(cpu_model.eval(), nway=4, chunk_size=4)(
        torch.as_tensor(ids[0, :4]), torch.as_tensor(am[0, :4]), torch.as_tensor(tt[:4]),
        torch.as_tensor(pix[:1]).float())[0].numpy()
    err = float(np.abs(logits[0, :4] - want).max())
    check(np.allclose(logits[0, :4], want, atol=RERANK_ATOL, rtol=RERANK_RTOL),
          f"4c logits {logits[0, :4]} vs CPU fp32 {want}")
    line = {"phase": "rerank_monopreflmr_l", "card": smi, "queries": BQ, "candidates": K,
            "seq_len": L, "joint_rows": Lj, "max_position_embeddings": P4C_MAX_POSITIONS,
            "batch_seconds": batch_s, "candidates_per_s": BQ * K / batch_s[-1],
            "vit_l14_prefix_ms_8_images": vit_ms,
            "vit_prefix_share_of_batch": vit_ms / 1e3 / batch_s[-1],
            "k2_share_of_batch": sum(r["ms"] * r["launches"] for r in k2_rows) / 2 / 1e3
            / batch_s[-1],
            "max_abs_err_vs_cpu_fp32": err, "tol": [RERANK_ATOL, RERANK_RTOL],
            "logit_std": float(logits.std()), "cpu_check_seconds": time.perf_counter() - t1,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "k2_shapes": {r["variant"]: r["launches"] for r in k2_rows},
            "launches": launches, "seconds": time.perf_counter() - t0}
    del reranker, cpu_model
    gc.collect()
    torch.cuda.empty_cache()
    return line, k2_rows


def _profile_kinds(fn):
    """Device ms of one call of ``fn`` by kind of kernel, from
    ``torch.profiler`` (None if it sees no device time), and its 8 kernels
    with the most time."""
    kernels = library_kernels(fn)
    if not kernels:
        return None, None
    kinds = (("K2", ("attention_kernel",)), ("int8_gemm", ("i8", "imma", "s8", "int8")),
             ("gemm", ("gemm", "nvjet", "gemv", "cutlass")), ("reduce", ("reduce",)),
             ("cast", ("direct_copy",)), ("elementwise", ("elementwise", "vectorized")))
    by_kind = {}
    for k in kernels:
        n = k["name"].lower()
        kind = next((a for a, subs in kinds if any(s in n for s in subs)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + k["us"] / 1e3
    top = sorted(kernels, key=lambda k: -k["us"])[:8]
    return by_kind, [{"name": k["name"][:120], "ms": k["us"] / 1e3, "count": k["count"]}
                     for k in top]


def w8a8_decoder(family, model, chunk, ids, am, pix, bf16_p_yes, smi):
    """Phases 5b and 6b: phase 5's or 6's model and weights with
    ``quantize_int8`` in the LM (every projection, FFN and head W8A8
    through ``torch._int_mm``; lora_r 0), the same prompts through
    ``make_decoder_rerank_fn``. K2 stays bf16 (head bias or causal hd 80).
    Each W8A8 layer's first rows against the same layer on the CPU, bitwise
    (``check_int8_layers``; T5's one-query cross-attention reads its K and V
    weights directly, as the JAX package's does); p(yes) of DECODER_CHECK
    prompts against the same W8A8 model on the card without the kernel.
    Returns (the line, K2's launches and shape)."""
    from reranking_multimodal_retrievers_tpu_torch.engine import make_decoder_rerank_fn
    from reranking_multimodal_retrievers_tpu_torch.models import OPTConfig
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import Blip2DecoderRerankModel
    from reranking_multimodal_retrievers_tpu_torch.ops.quant import Int8Linear

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = model.config
    text = cfg.blip2.text_config
    is_opt = isinstance(text, OPTConfig)

    cfg8 = dataclasses.replace(cfg, blip2=dataclasses.replace(
        cfg.blip2, text_config=dataclasses.replace(text, quantize_int8=True)))
    check(cfg8.blip2.text_config.lora_r == 0, f"{family}: W8A8 needs lora_r 0")
    model8 = Blip2DecoderRerankModel(cfg8, device="meta")  # phase 5's or 6's tensors
    model8.load_state_dict(model.state_dict(), assign=True)
    model8.eval()
    K = ids.shape[0]
    layers = {name: m for name, m in model8.named_modules() if isinstance(m, Int8Linear)}
    # the single-query cross-attention's K and V: weights read, no layer call
    unread = {n for n in layers if ".EncDecAttention.k" in n or ".EncDecAttention.v" in n}
    seen = {}
    hooks = [m.register_forward_hook(keep_first_rows(seen, name)) for name, m in layers.items()]
    fn = make_decoder_rerank_fn(model8, chunk_size=chunk)
    reset_counts()
    run_s = []
    try:
        for _ in range(2):  # the first run also warms up cuBLASLt
            t1 = time.perf_counter()
            p_yes = fn(ids, am, pix.to(torch.bfloat16))
            torch.cuda.synchronize()
            run_s.append(time.perf_counter() - t1)
            for h in hooks:  # the first run feeds the layer check
                h.remove()
    finally:
        for h in hooks:
            h.remove()
    launches = read_counts()
    n_layers = text.num_hidden_layers if is_opt else text.num_layers
    want_k2 = 2 * n_layers * (K // chunk)
    check(launches["K2"] == want_k2 and launches["K1"] == launches["K3"] == launches["K2f32"] == 0,
          f"{family} W8A8 launches {launches}, want K2 = {want_k2}")
    check(tuple(p_yes.shape) == (K,) and bool(torch.isfinite(p_yes).all())
          and bool(((p_yes >= 0) & (p_yes <= 1)).all()), f"{family} W8A8 p(yes) {p_yes}")
    check(set(seen) == set(layers) - unread,
          f"{family}: W8A8 layers run {len(seen)} of {len(layers) - len(unread)}")
    peak = torch.cuda.max_memory_allocated() / 1e9

    # where the device time goes, traced over the first chunk's prompts (a
    # trace of all K takes the profiler 40-70 s; not the main path's)
    t1 = time.perf_counter()
    by_kind, top = _profile_kinds(lambda: fn(ids[:chunk], am[:chunk], pix.to(torch.bfloat16)))
    profile_s = time.perf_counter() - t1

    t1 = time.perf_counter()
    layers_checked, layer_gap = check_int8_layers({n: layers[n] for n in seen}, seen)
    layer_check_s = time.perf_counter() - t1
    del seen
    n = DECODER_CHECK
    want = make_decoder_rerank_fn(_plain_twin(model8), chunk_size=n)(
        ids[:n], am[:n], pix.to(torch.bfloat16))
    err = (p_yes[:n].float() - want.float()).abs().max().item()
    check(err <= P_YES_TOL,
          f"{family} W8A8 p(yes) {p_yes[:n].tolist()} vs without K2 {want.tolist()}")

    a, b = p_yes.float().cpu().numpy(), bf16_p_yes.float().cpu().numpy()
    rho = float(np.corrcoef(np.argsort(np.argsort(a)), np.argsort(np.argsort(b)))[0, 1])
    device_ms = sum(by_kind.values()) if by_kind else None
    line = {"phase": f"rerank_{family}_w8a8", "card": smi, "candidates": K,
            "seq_len": ids.shape[1], "chunk_rows": chunk, "run_seconds": run_s,
            "candidates_per_s": K / run_s[-1], "peak_gb": peak,
            "int8_layers": len(layers), "int8_layers_bitwise": layers_checked,
            "int8_layers_weights_read": len(unread), "min_layer_gap_bf16": layer_gap,
            "layer_check_seconds": layer_check_s,
            "p_yes_checked": p_yes[:n].tolist(), "p_yes_without_kernel": want.tolist(),
            "max_abs_err_vs_without_kernel": err, "tol": P_YES_TOL,
            "max_abs_gap_vs_bf16": float(np.abs(a - b).max()), "spearman_vs_bf16": rho,
            "top1_same_as_bf16": bool(np.argmax(a) == np.argmax(b)),
            "p_yes_spread": [float(a.min()), float(a.max())],
            "profiled_prompts": chunk, "device_ms_by_kind": by_kind, "device_ms": device_ms,
            # W8A8's quantize and rescale passes are casts, elementwise
            # kernels and the row maxima (with the LayerNorms' and GELU's)
            "cast_elementwise_reduce_share": (
                sum(by_kind.get(k, 0.0) for k in ("cast", "elementwise", "reduce")) / device_ms
                if device_ms else None),
            "top_kernels": top, "profile_seconds": profile_s,
            "launches": launches, "seconds": time.perf_counter() - t0}
    del model8, fn
    gc.collect()
    torch.cuda.empty_cache()
    return line, {"launches": launches["K2"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from reranking_multimodal_retrievers_tpu_torch.engine import (
        TokenIndex, encode_corpus, make_chunked_rerank_fn, make_search_fn)
    from reranking_multimodal_retrievers_tpu_torch.models import (
        BertConfig, CLIPVisionConfig, FLMRConfig, FLMRModelForRetrieval, OPTConfig, T5Config)
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import (
        FullContextRerankModel, RerankConfig)
    from reranking_multimodal_retrievers_tpu_torch.ops import (
        _build, attention_cuda, maxsim_cuda, maxsim_int8_cuda)
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention, fused_self_attention_reference)
    from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_cuda import maxsim_scores_reference
    from reranking_multimodal_retrievers_tpu_torch.serving import RerankService, RetrievalService

    # ---- 0. the card
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "seconds": time.perf_counter() - t0})

    # ---- 1. build
    t0 = time.perf_counter()
    build_s = _build.build_all()
    maxsim_cuda._lib()  # load every library
    for hd in attention_cuda.KERNEL_HEAD_DIMS:
        attention_cuda._lib(hd)
        attention_cuda._lib_f32(hd)
    attention_cuda._lib_any(False)
    attention_cuda._lib_any(True)
    maxsim_int8_cuda._lib()
    sass = sass_counts("attention_f32")
    check(sass["HMMA_TF32"] > 0 and sass["LDGSTS"] > 0,
          f"K2's fp32 library: no TF32 HMMA or no cp.async in its SASS: {sass}")
    # the generic kernel: both products on the tensor cores, bf16 and TF32
    sass_any = {name: sass_counts(name) for name in _build.K2_ANY}
    check(sass_any["attention_any"]["HMMA_BF16"] > 0
          and sass_any["attention_any_f32"]["HMMA_TF32"] > 0
          and all(c["LDGSTS"] > 0 for c in sass_any.values()),
          f"K2's generic libraries: no bf16 or TF32 HMMA or no cp.async in their SASS: {sass_any}")
    ptxas = {name: ptxas_report(name) for name in _build.SOURCES}
    emit({"phase": "build", "nvcc_seconds": build_s, "ptxas": ptxas,
          "attention_f32_sass": sass, "attention_any_sass": sass_any,
          "seconds": time.perf_counter() - t0})
    for name in _build.K2_ANY:
        emit({"phase": "build", "library": name, "instances": [
            {key: e[key] for key in ("entry", "registers", "static_smem_bytes", "spill_bytes")}
            for e in ptxas[name]["entries"]]})
    if "--probe-t5-init" in sys.argv[1:]:
        emit(t5_init_probe(smi))
        return 0
    if sys.argv[1:3] == ["--phase", "13d"]:  # phases 0, 1 and 13d alone
        k1_rows, k3_rows, k2_rows, parts = p13_phases(smi, only_13d=True)
        source = "reranking_multimodal_retrievers_tpu_torch/csrc/"
        replaces = "reranking_multimodal_retrievers_tpu/ops/"
        emit({"kernels": [
            *(dict(name=f"maxsim_scores {r['variant']}", route="cuda", source=source + "maxsim.cu",
                   replaces=replaces + "maxsim_pallas.py:67", **r) for r in k1_rows),
            *(dict(name=f"maxsim_scores_int8 {r['variant']}", route="cuda",
                   source=source + "maxsim_int8.cu", replaces=replaces + "maxsim_pallas.py:183",
                   **r) for r in k3_rows),
            *(dict(name=f"fused_self_attention fp32 {r['variant']}", route="cuda",
                   source=k2_source(r["head_dim"], True),
                   replaces=replaces + "attention_pallas.py:95", **r) for r in k2_rows)],
            "not_ported": [], "phases_run": [0, 1, "13d", "13e"], "launches": parts})
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": torch.cuda.device_count()}})
        return 0
    if sys.argv[1:3] == ["--phase", "16"]:  # phases 0, 1 and 16 alone
        lines, k1_p16, k2f32_p16, p16_parts = p16_phase(smi)
        for line in lines:
            emit(line)
        emit({"kernels": [
            dict(name=f"maxsim_scores {k1_p16['variant']}", route="cuda",
                 source="reranking_multimodal_retrievers_tpu_torch/csrc/maxsim.cu",
                 replaces="reranking_multimodal_retrievers_tpu/ops/maxsim_pallas.py:67",
                 **k1_p16),
            *(dict(name=f"fused_self_attention fp32 {r['variant']}", route="cuda",
                   source=k2_source(r["head_dim"], True),
                   replaces="reranking_multimodal_retrievers_tpu/ops/attention_pallas.py:95",
                   **r) for r in k2f32_p16)],
            "not_ported": [], "phases_run": [0, 1, 16], "launches": p16_parts})
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": torch.cuda.device_count()}})
        return 0
    if sys.argv[1:3] == ["--phase", "15"]:  # phases 0, 1 and 15 alone
        lines, p15_rows, p15_parts = p15_phases(smi)
        for line in lines:
            emit(line)
        totals, per_shape = p15_kernel_rows(p15_rows, p15_parts)
        emit({"kernels": totals + per_shape, "not_ported": [], "phases_run": [0, 1, 15]})
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": torch.cuda.device_count()}})
        return 0

    # ---- 2. each kernel against its plain version, at main-path shapes
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, LQ, N, LD, DIM = 8, 113, 4096, 256, 128
    Q = unit(gen, B, LQ, DIM)
    D = unit(gen, N, LD, DIM)
    lens = torch.randint(1, LD + 1, (N,), device="cuda", generator=gen)
    M = torch.arange(LD, device="cuda")[None, :] < lens[:, None]
    M[7] = False  # a whole-padding doc
    k1 = check_k1(Q, D, M)
    emit({"phase": "kernel_check", "kernel": "K1 maxsim_scores", "card": smi, **k1})
    k3 = check_k3(Q, D, M)
    emit({"phase": "kernel_check", "kernel": "K3 maxsim_scores_int8", "card": smi, **k3})
    # bench.py's retrieval batch (B = 128 queries x L_q = 96, bench.py:560)
    # over the same docs
    Qb = unit(gen, BENCH_QUERIES, BENCH_LQ, DIM)
    k1_bench = check_k1(Qb, D, M, plain_reps=1)
    emit({"phase": "kernel_check", "kernel": "K1 maxsim_scores", "card": smi, **k1_bench})
    k3_bench = check_k3(Qb, D, M, crafted=False, plain_reps=1)
    emit({"phase": "kernel_check", "kernel": "K3 maxsim_scores_int8", "card": smi, **k3_bench})
    del D, M, Qb

    k2 = {}
    for L in (512, 593):
        BA, H, HD = 100, 12, 64
        q, k, v = (torch.randn(BA, L, H * HD, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        # text tails padded within the first 512 keys; rows past 512 (the
        # cross-encoder's vision rows) always valid
        tlen = torch.randint(256, 513, (BA,), device="cuda", generator=gen)
        pos = torch.arange(L, device="cuda")[None, :]
        keep = (pos < tlen[:, None]) | (pos >= 512)
        bias = torch.where(keep, 0.0, -1e9)
        kw = dict(num_heads=H, sm_scale=HD ** -0.5)
        got = fused_self_attention(q, k, v, bias, **kw)
        ref = fused_self_attention_reference(q, k, v, bias, **kw)
        err = (got.float() - ref.float()).abs().max().item()
        check(bool(torch.isfinite(got).all()) and err <= K2_TOL,
              f"K2 at L={L}: max |diff| {err} > {K2_TOL}")
        qh, kh, vh = (x.view(BA, L, H, HD).transpose(1, 2) for x in (q, k, v))
        amask = keep[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        flops = 4 * BA * H * L * L * HD
        b_ms, b_by = bound(flops, 4 * q.numel() * 2 + bias.numel() * 4)
        times = k2_timed(lambda: fused_self_attention(q, k, v, bias, **kw),
                         lambda: sdpa(qh, kh, vh, attn_mask=amask), flops, b_ms)
        k2[L] = dict(shape=[BA, L, H * HD], max_abs_err=err, tol=K2_TOL,
                     plain_ms=cuda_ms(lambda: fused_self_attention_reference(q, k, v, bias, **kw), 3),
                     bound_ms=b_ms, bound_by=b_by, flops=flops, **times)
        emit({"phase": "kernel_check", "kernel": "K2 fused_self_attention", **k2[L]})
        del q, k, v, got, ref
    k2f32_extra = k2f32_variants(gen, smi)
    k2_widths = k2_width_rows(gen, smi)
    # the admitted geometries outside the per-width kernels: the generic kernel
    # (each dtype's rows apart, so that each must launch it)
    k2_c9 = []
    for fp32, want in ((False, "attention_any"), (True, "attention_any_f32")):
        launches_any = attention_cuda.fused_self_attention_any.launches
        rows = k2_width_rows(gen, smi, ([], K2_C9) if fp32 else (K2_C9, []),
                             "K2 generic kernel (attention_any.cu)", profile=False,
                             earlier=K2_C9_EARLIER_MS)
        check(attention_cuda.fused_self_attention_any.launches > launches_any
              and all(r["library"] == want for r in rows),
              f"phase 2: the {'fp32' if fp32 else 'bf16'} C9 geometries did not run {want}")
        k2_c9 += rows
    # what the fp32 yardstick runs at the cross-encoder's launch shape (11d)
    q, k, v = (torch.randn(50, 12, 161, 64, device="cuda", generator=gen) for _ in range(3))
    amask = (torch.rand(50, 161, device="cuda", generator=gen) > 0.2)[:, None, None, :]
    emit({"phase": "library_kernels", "call": "scaled_dot_product_attention fp32, bool key "
          "mask, [50, 12, 161, 64]", "card": smi,
          "kernels": library_kernels(lambda: torch.nn.functional.scaled_dot_product_attention(
              q, k, v, attn_mask=amask, scale=0.125))})
    del q, k, v, amask
    emit({"phase": "kernel_checks", "seconds": time.perf_counter() - t0})

    # ---- 3. retrieve (main path)
    t0 = time.perf_counter()
    bert_kw = dict(use_pallas_attention=True, attention_scores_bf16=True, gelu_approximate=True)
    fcfg = FLMRConfig(text_config=BertConfig(**bert_kw), vision_config=CLIPVisionConfig(),
                      dim=128, mapping_network_prefix_length=32,
                      use_transformer_mapping_network=True,
                      transformer_mapping_num_hidden_layers=1)
    wgen = torch.Generator(device="cuda").manual_seed(SEED)
    flmr = FLMRModelForRetrieval(fcfg, device="cuda", dtype=torch.bfloat16, generator=wgen).eval()
    rng = np.random.default_rng(SEED)
    N_ENC, N_ALL, BQ, LQT, K = 1024, 100_000, 8, 32, 100
    dlen = rng.integers(32, LD + 1, size=N_ENC)
    d_am = (np.arange(LD)[None, :] < dlen[:, None]).astype(np.int64)
    d_ids = rng.integers(1000, 29000, size=(N_ENC, LD)) * d_am
    q_ids = rng.integers(1000, 29000, size=(BQ, LQT))
    q_am = np.ones((BQ, LQT), np.int64)
    pix = torch.as_tensor(rng.normal(size=(BQ, 3, 224, 224)).astype(np.float32)).to(torch.bfloat16)
    setup_s = time.perf_counter() - t0

    reset_counts()
    t1 = time.perf_counter()

    def doc_fn(batch):
        out = flmr.doc(batch[0].cuda(), batch[1].cuda())
        return out.late_interaction_output, out.context_mask

    batches = [(torch.as_tensor(d_ids[i:i + 128]), torch.as_tensor(d_am[i:i + 128]))
               for i in range(0, N_ENC, 128)]
    enc = encode_corpus(doc_fn, batches, [str(i) for i in range(N_ENC)], device="cuda")
    check(tuple(enc.embeddings.shape) == (N_ENC, LD, 128), f"doc matrices {enc.embeddings.shape}")
    emb = torch.empty(N_ALL, LD, 128, dtype=torch.bfloat16, device="cuda")
    emb[:N_ENC] = enc.embeddings
    for s in range(N_ENC, N_ALL, 8192):
        emb[s:min(N_ALL, s + 8192)] = unit(wgen, min(N_ALL, s + 8192) - s, LD, 128)
    mask = torch.ones(N_ALL, LD, dtype=torch.bool, device="cuda")
    mask[:N_ENC] = enc.mask
    index = TokenIndex(embeddings=emb, mask=mask, doc_ids=[str(i) for i in range(N_ALL)])
    del enc
    with torch.inference_mode():
        qout = flmr.query(torch.as_tensor(q_ids).cuda(), torch.as_tensor(q_am).cuda(),
                          pixel_values=pix.cuda())
    Qm = qout.late_interaction_output
    check(tuple(Qm.shape) == (BQ, 113, 128) and bool(torch.isfinite(Qm.float()).all()),
          f"query matrices {tuple(Qm.shape)}")
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t1

    svc = RetrievalService(make_search_fn(N_ALL, k=K), index, batch_queries=BQ, max_wait_ms=50)
    try:
        t2 = time.perf_counter()
        results = [f.result(timeout=600) for f in [svc.search(Qm[i]) for i in range(BQ)]]
        search_s = time.perf_counter() - t2
    finally:
        svc.close()
    torch.cuda.synchronize()
    retrieve_launches = read_counts()
    check(retrieve_launches["K1"] > 0 and retrieve_launches["K2"] > 0,
          f"retrieve launches {retrieve_launches}")

    # the search program alone (K1 over every slab + top-k), after the counts
    # were read: these launches are not the main path's
    search_ms = cuda_ms(lambda: make_search_fn(N_ALL, k=K)(Qm, index.embeddings, index.mask), 3)
    search_bound, search_by = bound(2 * BQ * 113 * N_ALL * LD * 128,
                                    Qm.numel() * 2 + emb.numel() * 2 + mask.numel() + BQ * N_ALL * 4)
    ref_scores = maxsim_scores_reference(Qm, index.embeddings, index.mask)
    ref_vals, ref_idx = torch.topk(ref_scores, K, dim=1)
    identical, worst = 0, 0.0
    for i, (ids, vals) in enumerate(results):
        got_idx = torch.as_tensor([int(x) for x in ids], device="cuda")
        check(len(ids) == K and bool(np.isfinite(vals).all()), f"query {i}: {len(ids)} results")
        identical += int(torch.equal(got_idx, ref_idx[i]))
        # ranks may differ only between docs whose plain scores lie within
        # the K1 tolerance; the served values match the plain scores
        swap = (ref_scores[i, got_idx] - ref_vals[i]).abs().max().item()
        served = (torch.as_tensor(vals, device="cuda") - ref_scores[i, got_idx]).abs().max().item()
        worst = max(worst, swap, served)
    check(worst <= K1_TOL, f"retrieval top-{K} off the plain version by {worst}")
    emit({"phase": "retrieve", "index": [N_ALL, LD, 128], "queries": BQ, "k": K,
          "setup_seconds": setup_s, "encode_seconds": encode_s, "search_seconds": search_s,
          "search_ms": search_ms, "search_bound_ms": search_bound, "search_bound_by": search_by,
          "identical_rankings": identical, "max_abs_err": worst,
          "launches": retrieve_launches, "seconds": time.perf_counter() - t0})
    candidates = [[int(x) for x in ids] for ids, _ in results]
    # phase 9c's inputs: the candidates' token matrices and masks, from the
    # index, as at test time
    position = {doc: i for i, doc in enumerate(index.doc_ids)}
    cand = torch.as_tensor([[position[str(c)] for c in row] for row in candidates],
                           device="cuda")
    retrieved = (Qm, qout.query_mask.int(), index.embeddings[cand], index.mask[cand].int())
    del ref_scores, cand
    # phase 3e's traffic: phase 3's docs and queries
    p3_corpus = (batches, [str(i) for i in range(N_ENC)])
    p3_queries = (torch.as_tensor(q_ids), torch.as_tensor(q_am), pix)

    # ---- 3d. raw images preprocessed on the card into phase 3's FLMR and
    # index (main path)
    line, p3d_carry, k1_p3d, k2_p3d = p3d_raw_images(flmr, index, smi)
    p3d_launches = line["launches"]
    emit(line)
    del flmr
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 3e. PreFLMR-L and PreFLMR-G over phase 3's docs and queries (main
    # path), each against an fp32 copy of its weights without the kernels
    p3e_launches, k1_p3e, k2_p3e = [], [], []
    for scale in P3E_SCALES:
        line, k1_rows, k2_rows = p3e_preflmr(scale, index, p3_corpus, p3_queries, bert_kw, smi)
        p3e_launches.append(line["launches"])
        k1_p3e += k1_rows
        k2_p3e += k2_rows
        emit(line)
    del p3_corpus

    # ---- 3b. int8 retrieve over the same index, quantized on the card (main path)
    qindex, line = int8_retrieve(index, Qm, K, candidates)
    int8_launches = line["launches"]
    int8_search = (line["search_ms"], line["search_bound_ms"])
    emit(line)
    del emb, mask  # phase 10 takes the index again

    # ---- 3c. the int8 index streamed from host RAM (main path)
    line = streamed_retrieve(qindex, Qm, K, wgen)
    stream_launches = line["launches"]
    emit(line)
    del qindex

    # ---- 4. rerank (main path)
    t0 = time.perf_counter()
    L = 512
    rcfg = RerankConfig(flmr=fcfg, cross_encoder=BertConfig(
        num_hidden_layers=1, max_position_embeddings=768, **bert_kw),
        loss_fn="BCE", max_query_length=LQT, max_decoder_source_length=L)
    reranker = FullContextRerankModel(rcfg, device="cuda", dtype=torch.bfloat16,
                                      generator=wgen).eval()
    ids = np.zeros((BQ, K, L), np.int64)
    am = np.zeros((BQ, K, L), np.int64)
    for i in range(BQ):
        for j, doc in enumerate(candidates[i]):
            drng = np.random.default_rng([SEED, doc])  # the candidate's own text
            n = int(drng.integers(100, L - LQT + 1))
            ids[i, j, :LQT] = q_ids[i]
            ids[i, j, LQT:LQT + n] = drng.integers(1000, 29000, size=n)
            am[i, j, :LQT + n] = 1
    tt = np.zeros((K, L), np.int64)
    tt[:, LQT:] = 1
    rsvc = RerankService(make_chunked_rerank_fn(reranker, nway=K, chunk_size=100), nway=K,
                         max_batch=BQ, max_wait_ms=50, device="cuda")
    reset_counts()
    try:
        batch_s = []
        for _ in range(2):  # the first batch also warms up cuBLAS
            t1 = time.perf_counter()
            futs = [rsvc.rerank(ids[i], am[i], tt, pix[i]) for i in range(BQ)]
            logits = np.stack([f.result(timeout=600) for f in futs])
            batch_s.append(time.perf_counter() - t1)
    finally:
        rsvc.close()
    torch.cuda.synchronize()
    rerank_launches = read_counts()
    check(logits.shape == (BQ, K) and bool(np.isfinite(logits).all()), f"logits {logits.shape}")
    check(rerank_launches["K2"] > 0, f"rerank launches {rerank_launches}")

    t1 = time.perf_counter()
    cpu_model = FullContextRerankModel(rcfg, device="meta")  # weights come below
    cpu_state = {k: v.float().cpu() for k, v in reranker.state_dict().items()}
    cpu_model.load_state_dict(cpu_state, assign=True)
    want = make_chunked_rerank_fn(cpu_model, nway=4, chunk_size=4)(
        torch.as_tensor(ids[0, :4]), torch.as_tensor(am[0, :4]), torch.as_tensor(tt[:4]),
        pix[:1].float())[0].numpy()
    rerank_err = float(np.abs(logits[0, :4] - want).max())
    check(np.allclose(logits[0, :4], want, atol=RERANK_ATOL, rtol=RERANK_RTOL),
          f"rerank logits {logits[0, :4]} vs CPU fp32 {want}")
    emit({"phase": "rerank", "queries": BQ, "candidates": K, "seq_len": L,
          "batch_seconds": batch_s, "candidates_per_s": BQ * K / batch_s[-1],
          "card": smi, "max_abs_err_vs_cpu_fp32": rerank_err, "logit_std": float(logits.std()),
          "cpu_check_seconds": time.perf_counter() - t1, "launches": rerank_launches,
          "seconds": time.perf_counter() - t0})

    # ---- 4b. the same rerank with every BERT dense layer W8A8 (main path)
    line = w8a8_rerank(reranker, rcfg, ids, am, tt, pix, logits, cpu_state)
    w8a8_launches = line["launches"]
    emit({**line, "card": smi})

    del reranker, cpu_model, cpu_state
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 4c. monoPreFLMR-L over the same traffic (main path): the joint
    # sequence of 512 text + 32 prefix + 256 patch rows
    line, k2_p4c = p4c_rerank_l(_preflmr_config("L", **bert_kw), (ids, am, tt, pix), bert_kw,
                                smi)
    p4c_launches = line["launches"]
    emit(line)

    # ---- 5. monoBLIP2-Flan-T5 (main path), 5b. the same weights and
    # prompts with the LM W8A8 (main path)
    def w8a8(family, chunk):
        return lambda model, *inputs: w8a8_decoder(family, model, chunk, *inputs, smi)

    line, k2_t5, (line_5b, k2_t5_w8a8) = decoder_rerank(
        "blip2_flan_t5_xl", T5Config.flan_t5_xl(use_pallas_attention=True, position_bias_bf16=True),
        chunk=10, yes_no=T5_YES_NO, vocab_hi=30000, smi=smi, then=w8a8("blip2_flan_t5_xl", 10))
    emit(line)
    emit(line_5b)

    # ---- 6. monoBLIP2-Opt (main path), 6b. W8A8 (main path)
    line, k2_opt, (line_6b, k2_opt_w8a8) = decoder_rerank(
        "blip2_opt_2_7b", OPTConfig.opt_2_7b(use_pallas_attention=True), chunk=5,
        yes_no=OPT_YES_NO, vocab_hi=50000, smi=smi, then=w8a8("blip2_opt_2_7b", 5))
    emit(line)
    emit(line_6b)

    # ---- 8. FLMR training, 8b. the reranker's train step and W8A8's backward
    emit(flmr_training(smi))
    emit(rerank_training(smi))
    emit(int8_linear_backward(smi))

    # ---- 9. the interaction rerankers (main path), 9d. MORES's train step
    t0 = time.perf_counter()
    lines, k2_inter = interaction_phases(retrieved, smi)
    for line in lines:
        emit(line)
    del retrieved
    emit(mores_training(smi))
    emit({"phase": "interaction", "seconds": time.perf_counter() - t0})

    # ---- 10. the rest of the engine (main path): compressed retrieval over
    # phase 3's index, the pooled index, two Baleen hops, the triples trainer
    t0 = time.perf_counter()
    line, k1_plaid, (Qb, exact_ids) = compressed_retrieval(index, Qm, smi)
    plaid_launches = line["launches"]
    emit(line)
    line, k1_pooled = pooled_retrieval(index, Qb, exact_ids, smi)
    pooled_launches = line["launches"]
    emit(line)
    del index, Qb
    gc.collect()
    torch.cuda.empty_cache()
    line, k2_baleen = baleen(smi)
    baleen_launches = line["launches"]
    emit(line)
    line = triples_training(smi)
    triples_launches = line["launches"]
    emit(line)
    emit({"phase": "engine", "seconds": time.perf_counter() - t0})
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 11. the CLI at full width (main path): FLMR train, test (K1, fp32
    # K2), int8 test (K3), reranker train and test (fp32 K2)
    t0 = time.perf_counter()
    lines, k1_cli, k3_cli, k2f32_rows, cli_parts = cli_phases(smi)
    for line in lines:
        emit(line)
    emit({"phase": "cli", "seconds": time.perf_counter() - t0})

    # ---- 12. the interaction, fusion and decoder rerankers and RAG from the
    # CLI at full width (main path), over phase 11's dataset and checkpoint
    t0 = time.perf_counter()
    try:
        k2f32_p12, p12_parts = p12_phases(smi)
    finally:
        if CLI_DIR.exists():
            shutil.rmtree(CLI_DIR)
    emit({"phase": "cli_families", "seconds": time.perf_counter() - t0})

    # ---- 13. real-format M2KR data (save_to_disk directories, the baseline
    # JPEG), prepare_data through the captioner, ViT features and the live
    # teacher, then FLMR train and test over it (main path)
    t0 = time.perf_counter()
    k1_p13, k3_p13, k2f32_p13, p13_parts = p13_phases(smi)
    emit({"phase": "real_data", "seconds": time.perf_counter() - t0})

    # ---- 14. the tools: BEM scoring (fp32 K2, main path), the host ops over
    # 3d's results, checkpoint conversion of phase 3's FLMR, a job script,
    # the prediction dumps' tools
    t0 = time.perf_counter()
    k2f32_p14, p14_launches = p14_phases(p3d_carry, fcfg, smi)
    del p3d_carry
    emit({"phase": "tools", "seconds": time.perf_counter() - t0})

    # ---- 15. several ranks (main path): the train step at dp 4 and dp 2 x
    # tp 2, the corpus encode, the 100k search, the rerank and the decoder
    # rerankers sharded over 4 ranks, each against one process; the CLI's
    # --n_devices 4 (its overask error on fewer than 4 cards)
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    lines, p15_rows, p15_parts = p15_phases(smi)
    for line in lines:
        emit(line)
    emit({"phase": "ranks", "seconds": time.perf_counter() - t0})

    # ---- 16. PreFLMR-G as published, fine-tuned and tested from the CLI
    # over the committed M2KR snapshot (main path)
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    lines, k1_p16, k2f32_p16, p16_parts = p16_phase(smi)
    for line in lines:
        emit(line)
    emit({"phase": "preflmr_g_cli", "seconds": time.perf_counter() - t0})

    # ---- 7. the kernels line and the result
    torch.cuda.synchronize()
    phases = (retrieve_launches, p3d_launches, *p3e_launches, int8_launches, stream_launches,
              rerank_launches, w8a8_launches, p4c_launches, line_5b["launches"],
              line_6b["launches"], plaid_launches, pooled_launches, baleen_launches,
              triples_launches, *cli_parts.values(), *p12_parts.values(), *p13_parts.values(), p14_launches,
              *p15_parts.values(), *p16_parts.values())

    def launches(name):
        return sum(p[name] for p in phases)

    def k2_line(variant, k2_line):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "x_library", "share_of_bound", "tflops", "shape", "tol", "launches")
        return dict(name=f"fused_self_attention {variant}", route="cuda",
                    source="reranking_multimodal_retrievers_tpu_torch/csrc/attention.cu",
                    replaces=attention, **{key: k2_line[key] for key in keys},
                    **{key: k2_line[key] for key in ("dtype", "heads", "mask") if key in k2_line})

    def search_100k(ms, bound_ms, rate_key):
        """The 100k search of phase 3 or 3b (kernel launches over 4 slabs
        and the top-k) beside the kernel's bound for the same work."""
        ops = 2 * BQ * 113 * N_ALL * LD * 128
        return {"search_100k_ms": ms, "search_100k_bound_ms": bound_ms,
                "search_100k_share_of_bound": bound_ms / ms,
                f"search_100k_{rate_key}": ops / (ms * 1e-3) / 1e12}

    attention = "reranking_multimodal_retrievers_tpu/ops/attention_pallas.py:95"
    widths = [dict(name=f"fused_self_attention {row['variant']}", route="cuda",
                   replaces=attention, **row) for row in k2_widths + k2_c9]
    kernels = [
        dict(name="maxsim_scores", route="cuda",
             source="reranking_multimodal_retrievers_tpu_torch/csrc/maxsim.cu",
             replaces="reranking_multimodal_retrievers_tpu/ops/maxsim_pallas.py:67",
             launches=launches("K1"), **k1, at_bench_batch=k1_bench,
             **search_100k(search_ms, search_bound, "tflops")),
        dict(name="fused_self_attention", route="cuda",
             source="reranking_multimodal_retrievers_tpu_torch/csrc/attention.cu",
             replaces=attention, launches=launches("K2"), **k2[512], at_593=k2[593]),
        k2_line("head_bias bf16 (Flan-T5-XL encoder)", k2_t5),
        k2_line("causal, head_dim 80 (OPT-2.7b)", k2_opt),
        # 5b and 6b launch K2 at phase 5's and 6's shapes: the same
        # variant's numbers, measured in phases 5 and 6, with W8A8's launches
        k2_line("head_bias bf16 (Flan-T5-XL encoder under W8A8, 5b; timed in phase 5)",
                {**k2_t5, **k2_t5_w8a8}),
        k2_line("causal, head_dim 80 (OPT-2.7b under W8A8, 6b; timed in phase 6)",
                {**k2_opt, **k2_opt_w8a8}),
        *(k2_line(row["variant"], row) for row in k2_p3e + k2_p4c),
        k2_line("key bias L=640 (interaction CrossEncoder, 9a)", k2_inter["9a"]),
        k2_line("key bias L=369 (interaction CrossEncoder on retrieved docs, 9c)",
                k2_inter["9c"]),
        k2_line("key bias L=512, 16 heads (Baleen reader, 10c)", k2_baleen),
        *(k2_line(row["variant"], row) for row in k2_p3d),
        dict(name="maxsim_scores stage 1 of compressed search (10a)", route="cuda",
             source="reranking_multimodal_retrievers_tpu_torch/csrc/maxsim.cu",
             replaces="reranking_multimodal_retrievers_tpu/ops/maxsim_pallas.py:67", **k1_plaid),
        dict(name="maxsim_scores pooled index, L_d = 128 (10b)", route="cuda",
             source="reranking_multimodal_retrievers_tpu_torch/csrc/maxsim.cu",
             replaces="reranking_multimodal_retrievers_tpu/ops/maxsim_pallas.py:67", **k1_pooled),
        dict(name="maxsim_scores_int8", route="cuda",
             source="reranking_multimodal_retrievers_tpu_torch/csrc/maxsim_int8.cu",
             replaces="reranking_multimodal_retrievers_tpu/ops/maxsim_pallas.py:183",
             launches=launches("K3"), **k3, at_bench_batch=k3_bench,
             **search_100k(*int8_search, "tops")),
        dict(name="maxsim_scores CLI test over the 30,000-doc index (11b)", route="cuda",
             source="reranking_multimodal_retrievers_tpu_torch/csrc/maxsim.cu",
             replaces="reranking_multimodal_retrievers_tpu/ops/maxsim_pallas.py:67", **k1_cli),
        dict(name="maxsim_scores_int8 CLI int8 test (11c)", route="cuda",
             source="reranking_multimodal_retrievers_tpu_torch/csrc/maxsim_int8.cu",
             replaces="reranking_multimodal_retrievers_tpu/ops/maxsim_pallas.py:183", **k3_cli),
        *(dict(name=f"maxsim_scores {row['variant']}", route="cuda",
               source="reranking_multimodal_retrievers_tpu_torch/csrc/maxsim.cu",
               replaces="reranking_multimodal_retrievers_tpu/ops/maxsim_pallas.py:67", **row)
          for row in k1_p3d + k1_p3e + k1_p13 + [k1_p16]),
        *(dict(name=f"maxsim_scores_int8 {row['variant']}", route="cuda",
               source="reranking_multimodal_retrievers_tpu_torch/csrc/maxsim_int8.cu",
               replaces="reranking_multimodal_retrievers_tpu/ops/maxsim_pallas.py:183", **row)
          for row in k3_p13),
        *(dict(name=f"fused_self_attention fp32 {row['variant']}", route="cuda",
               source=k2_source(row["head_dim"], True), replaces=attention, **row)
          for row in k2f32_rows + k2f32_p12 + k2f32_p13 + k2f32_p14 + k2f32_p16 + k2f32_extra),
        *p15_kernel_rows(p15_rows, p15_parts)[1]]
    k2_width_launches(widths, kernels)
    for row in widths[len(k2_widths):]:  # the generic kernel's launches in the whole main path
        row["launches_generic_kernel_main_path"] = sum(p.get("K2any", 0) for p in phases)
        row["main_path_note"] = ("no configuration reaches this geometry; ViT-G's 16 x 104 is "
                                 "in the ViT, which fuses in neither package")
    emit({"kernels": kernels + widths, "not_ported": []})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:  # 3d writes phase 14's inputs there
        shutil.rmtree(P14_DIR, ignore_errors=True)
