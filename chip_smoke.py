"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``multimodal_tpu_torch/csrc`` and runs,
in order (any failure exits non-zero):

1. the card's name and power limit, and the kernels' build time;
2. each kernel against its plain PyTorch version on the card, at the CLIP
   ViT-B/32 shapes (both towers; batch 512 for the forward kernels, the
   train step's 256 for the backward ones) in bf16 and fp32, plus every
   MLP activation, head width 96 and the attention key-bias lane at small
   shapes, and the attention backward (#2) past S = 128 (its `wgmma`
   route): S = 129, ViT-B/16's S = 197 at batch 256, S = 256 at head width
   64 and S = 181 at 128 (the forward's largest there), and #1 and #2 at
   ALBEF's text tower (32, 30, 3 x 768, 12 heads, a key bias), #1 also with
   a key bias under the causal mask at S = 256 and at a ragged S = 193 (its
   `wgmma` route's edges) and with causal rows whose every visible key the
   bias masks at S = 256 (the mean of V over all S keys), each #1 and #2 case also relaunched into an
   output filled with NaN, bitwise equal: max abs error against its
   tolerance, and the kernel's, the plain version's and one library call's
   times (the events' and the profiler's device ms) beside the card's
   bound; #2's two bf16 routes timed against each other at S = 16 to 128
   (the numbers ``_BWD_WGMMA_MIN_SEQ`` is set from);
3. CLIP ViT-B/32 embedding serving at full width and depth, random weights
   from a seed: an image server (uint8 256x256 -> preprocess ->
   encode_image) and a text server (token ids -> encode_text) answer
   requests of 1, 3, 64 and 300 rows; the launch counters must show 12
   launches of each kernel per tower forward; 4 image and 4 text rows are
   held against the same weights in fp32 on the CPU (cosine >= 0.999);
   pairs/s at batch 512;
4. one CLIP ViT-B/32 contrastive train step at full width and depth, batch
   256 (bench.py's train step): fp32 parameters, bf16 compute, random
   weights from a seed, the port's ``Trainer`` with AdamW (weight decay
   1e-4, as ``optax.adamw(1e-4)``). The gradients of 8 pairs are held
   against an fp32 step of the same weights on the CPU (concatenated
   cosine >= 0.99; its MLP backward is #4, 24 launches); then 2 warm-up
   steps and 10 timed steps, which must show 24 launches a step of #1, #2
   and #3, and 24 of the MLP backward (#4 for the vision tower's 12,800
   rows, #5 for the text tower's 19,712, by ``fused_mlp_bwd_acc_supported``)
   and finite losses; items/s,
   ms a step, peak memory and one step's device time by kernel group; then
   CLIP ViT-B/16's gradients at 2 pairs (vision S = 197, #2 past S = 128)
   against fp32 on the CPU (cosine >= 0.99, 24 launches of #2), and its
   train step at batch 256 (1 warm-up, 3 timed steps, 24 launches a step of
   #1 and #2, one step's device time by kernel group);
5. CLIP ViT-L/14's image tower (S = 257, past the fused kernels) at batch 8
   on the card against fp32 on the CPU (cosine >= 0.999);
6. long-context LM serving at bench.py's serving width and depth (12
   layers, d_model 768, 12 heads, d_ff 3072, vocab 32768, bf16, random
   weights from a seed) through ``InferenceEngine`` (32 slots, 4096-long
   int8 KV cache, prefill batch 8, 16 decode ticks a call, top-k 50): 48
   requests with prompts of 600-3000 tokens and 32-128 new tokens, half
   greedy, half at temperature 1. Every request must reach its length; the
   counters must show 12 launches of #6 per prefill call, 12 of #10 per
   decode tick and 12 of #3 per either; 2 requests' logits, teacher-forced
   with an int8 cache, are held against fp32 on the CPU (cosine >= 0.99);
   prefill and decode tokens/s, ms a tick, time to first token, peak
   memory and the device time of one prefill and one decode call by
   kernel group;
7. long-context LM training at the recipe's defaults
   (``examples/long_context/train.py``: 12 layers, d_model 768, 12 heads,
   d_ff 3072, vocab 32000, fp32 parameters, bf16 compute, remat, global-norm
   clipping + AdamW) through ``build_trainer`` and ``Trainer.fit``: the
   gradients of one packed row (1 x 1024 tokens, segment ids on) held
   against an fp32 step of the same weights on the CPU (concatenated cosine
   >= 0.99; its MLP backward is #4, 12 launches); 2 warm-up and 5 timed
   steps on synthetic windows of batch 8 x 8192, whose counters must show,
   a step, 24 launches of #6 (forward and remat recompute), 12 of the
   backward (#7 + #8 as one call), 0 of #9, 24 of #3 and 12 of #5 (#4
   none), and finite losses;
   tokens/s, ms a step, peak memory and one step's device time by kernel
   group; then the recipe's ``main`` with ``--packed-docs synthetic --steps
   2 --bf16`` (batch 8 x 8192), finite losses;
8. FLAVA pretraining at the recipe's defaults
   (``examples/flava/pretrain.py``, ``base``: 12 image, 12 text and 6
   multimodal layers, width 768, ffn 3072, image 224/16, text 77, vocab
   30522, fp32 parameters, bf16 compute, AdamW with the warmup-cosine
   schedule, random weights from a seed) through ``build_trainer_and_state``
   and ``Trainer.fit`` on the recipe's synthetic batches: the gradients of 2
   pairs held against an fp32 step of the same weights on the CPU
   (concatenated cosine >= 0.99; #3 and #4 54 launches each, no attention
   kernel: the towers ask for attention probabilities); 2 warm-up and 5
   timed steps at batch 64, whose counters must show 54 launches a step of
   #3 (image and text towers twice, the multimodal encoder once) and of the
   MLP backward by the predicate (#4 for the towers' 12,608 and 4,928 rows,
   48; #5 for the multimodal encoder's 17,600, 6) and none of #1, #2 or #6,
   and finite losses; items/s, ms a step,
   peak memory and one step's device time by kernel group; then the
   recipe's ``main`` (batch 64, 2 steps), finite losses;
9. FLAVA from real data at ``base`` (the recipes of phase 8 on a seeded
   local dataset written to a temporary directory: 256 {.npy uint8
   256x256x3, text, label} pairs, 64 images in two class directories, 128
   caption pairs; each image a mosaic of 16 x 16 cells of random colours,
   flat or textured): the host transform's ms an image; the dVAE
   codebook's bf16 logits on the card against fp32 on the CPU over 8
   images (cosine >= 0.999, and >= 0.999 once each logit channel's mean
   over positions is taken away; at least 5 distinct fp32 labels; the
   labels' agreement printed); the gradients of the six
   FLAVA losses (an image-text batch with dVAE labels, an image-only and a
   text-only batch, 2 pairs each) against fp32 on the CPU with the card's
   labels (cosine >= 0.99, exact #3 and #4 launches); 2 warm-up and 5
   timed steps at batch 64 on ``real_batches`` (``VLDataModule``, the
   two-way FLAVA transform, HashTokenizer, MLM masking, ITM negatives):
   exact #3, #4 and #5 launches a step (54, 48, 6), finite losses, items/s,
   ms a step, peak memory; 3 steps under the profiler (device ms by kernel
   group, the dVAE's kernels its own ``dvae`` group, the idle share); an
   image-only (MIM) and a text-only (MLM) step; the recipe's ``main`` for 7
   steps saving every 3, its step-6 checkpoint taken away and a second
   ``main`` resuming at step 3, steps 4-7's losses within ``RESUME_TOL``
   (1e-6 of the loss; every card run so far gave them bitwise equal) of
   the uninterrupted run's; ``main`` with ``train.pure_bf16`` for 3 steps
   with the ImageNet zero-shot eval (the full 1,000 x 80 protocol over the
   64 images) and the COCO retrieval eval through ``train.eval_every``
   (each eval's seconds and exact launches); ``finetune.py`` at ``base``
   from the labelled pairs for 3 steps, then resumed from its checkpoint
   for 2 more (exact launches);
10. CLIP zero-shot classification from strings and uint8 images, the
   ImageNet protocol (1,000 class names x 80 templates): the 80,000 prompts
   through the port's ``CLIPTextTransform`` on the native tokenizer
   (``native/bpe.py``, built by g++ at first use), every id row held equal
   to the Python tokenizer's, prompts/s, native calls and per-word
   fallbacks; then for ``clip_vit_b32`` and ``clip_rn50`` (bf16, seed 0;
   RN50's BatchNorms drawn from a seed): the classifier through a text
   ``EmbeddingServer`` (max_batch 256: 313 text forwards, exact launches of
   #1 and #3), 8 classes' columns against fp32 on the CPU (cosine >=
   0.999), ``imagenet_zero_shot_eval`` over 4,096 seeded 256x256 images with
   seeded labels in batches of 256 (device preprocessing, the image tower:
   ViT-B/32 #1 and #3, RN50's attention pool #6 once a batch; exact
   launches), 4 images' logits against fp32 on the CPU (cosine >= 0.999),
   images/s, top-1/top-5 (chance with random weights) and one image batch's
   device time by kernel group; one forward of 2 images through each of
   ``clip_rn101``, ``clip_rn50x4``, ``clip_rn50x16`` and ``clip_rn50x64`` at
   full width (unit-norm embeddings, one #6 launch each); and
   ``BASELINE.json``'s transform + encode p50/p90 latency
   (``scripts/bench_latency.py``'s definition: batch 32, ViT-B/32, 20 runs
   on distinct inputs) from ids and from prompt strings; the phase's wall
   time;
11. ALBEF retrieval and VQA fine-tuning at the published widths (ViT-B/16
   at 384, 577 image tokens; a 6-layer BERT text tower, 30 tokens; 6
   cross-attention layers; 768 -> 256 projections, queue 65,536, temperature
   0.07, momentum 0.995, alpha 0.4; fp32 parameters, bf16 compute; random
   weights from a seed) on a seeded local dataset in a temporary directory:
   the retrieval step's gradients at 2 pairs (the queue drawn on the CPU
   from a seed and copied) against an fp32 step of the same weights on the
   CPU (concatenated cosine >= 0.99) and the image, text and multimodal
   features (cosine >= 0.999), exact launches; 2 warm-up and 5 timed steps
   of ``albef_retrieval_train_step`` at batch 32 from
   ``RetrievalTrainingDataModule`` (``CLIPImageTransform(384)``, WordPiece
   ``BertTextTransform`` over a vocabulary the phase writes) with AdamW (lr
   1e-5, weight decay 0.02) on ``albef_cosine_lr`` / ``albef_alpha_schedule``:
   exact launches a step of #1, #2, #3, #4, #5, #6 and the flash backward
   (derived from the dispatch predicates), finite losses, the queue pointer
   advancing 32 a step, one momentum tensor equal to the EMA formula;
   items/s, ms a step, peak memory, one step's device time by kernel group
   and the idle share; retrieval inference over 128 images and 640
   captions (features, the ITC matrix, ``retrieval_rerank``'s ITM rerank of
   the top 128 both ways; seconds, exact launches, Recall@1/5/10, chance with
   random weights); VQA: ``vqa_answer_loss``'s gradients at 2 questions
   against fp32 on the CPU (cosine >= 0.99), then 1 warm-up and 3 timed
   steps at batch 32 from ``VQADataModule`` (up to 10 answers of 10 tokens
   a question, weighted; only each question's real answers decoded): exact
   launches, questions/s;
12. CoCa ViT-L/14 pretraining and captioning at the published widths
   (``coca_vit_l_14``: a 24-layer ViT-L/14 at 224 without a CLS token, 256
   tokens; the cascaded attention pooler, 256 queries then 1, 8 heads of
   96; a 12-layer text decoder of 77 positions and 12 fusion layers, 768
   wide, vocab 49,408; fp32 parameters, bf16 compute, random weights from a
   seed): the contrastive embeddings and captioning logits at batch 4 and
   ``CoCaForPretraining``'s gradients at 2 pairs against fp32 on the CPU
   (cosines >= 0.999 and >= 0.99), exact launches; 2 warm-up and 5 timed
   steps at batch 32 through the ``Trainer`` (AdamW) on seeded batches
   with seeded text lengths and padding: exact launches a step of #1, #2,
   #3, #4, #6 and the flash backward derived from the dispatch predicates
   (#5 and #9 none), finite losses, items/s, ms a step, peak memory, one
   step's device time by kernel group and the idle share; then
   ``CoCaCaptionServer`` over a bf16 copy: 64 seeded images encoded, then
   captioned from the start token for 75 tokens on 32 slots with the int8
   cache, half greedy, half top-k 50 at temperature 1: every request at its
   length, exact #10 and #3 launches a tick, 2 served captions'
   teacher-forced logits through the int8 cache against fp32 on the CPU
   (cosine >= 0.99), captions/s, decode tokens/s, host and device ms a
   tick, TTFT p50 and one decode call's device time by kernel group;
13. BLIP-2 stage 1 at the published widths (the port's ViT-L/14 image tower,
   23 layers, 257 tokens, frozen; ``QformerForCLM``, 12 layers, 768 wide,
   cross-attention every 2nd layer to 1024, 32 queries, vocab 30,523; fp32
   parameters, bf16 compute, random weights from a seed): the features and
   prediction scores at batch 4 and ``blip2_phase1_loss``'s gradients at 2
   pairs (the card's hard negatives replayed on the CPU) against fp32 on
   the CPU, no gradient in the tower; 2 warm-up and 5 timed steps at batch
   128 (AdamW, betas 0.9 / 0.98, weight decay 0.05) with exact launches,
   items/s, ms a step, peak memory, a step's device time by group and the
   idle share; then ``Blip2CaptionServer`` over a bf16 copy: 64 images
   primed, captioned from BOS for 31 tokens on 32 slots with the int8
   cache, half greedy and half sampled, with the same checks and rates as
   CoCa's (#10 and #3 12 times a tick and a prefill call);
14. MUGEN text-to-video retrieval at the recipe's defaults
   (``examples/mugen/retrieval_train.py``: S3D and DistilBERT 6 x 768,
   batch 16, 32 frames every 3rd, text 32, AdamW lr 1e-3 and weight decay
   1e-3, fp32 parameters and bf16 compute, random weights from a seed) on a
   seeded release written to a temporary directory (96-frame uint8 clips at
   256 x 256, resized on the card by ``VideoTransform``): 2 warm-up and 5
   timed steps through ``build_trainer_and_state`` and ``Trainer.fit``
   (no kernel launches: both towers train at dropout 0.1), items/s, ms a
   step, peak memory, a step's device time by group and the idle share;
   recall@{1,5,10} both ways over the 64-clip val split (#1 and #3 6 times
   a text batch); the bf16 towers against an fp32 copy of the weights on
   the card (row cosine >= 0.99);
15. MDETR phrase grounding (``mdetr_for_phrase_grounding``: ResNet-101,
   RoBERTa-base, d_model 256, 8 heads of 32, 6 + 6 layers, 100 queries,
   bf16 compute, random weights) on 32 seeded 800 x 1066 and 1066 x 800
   images with captions of up to 64 words and their Flickr30k Entities
   files: ``evaluate_phrase_grounding`` at batch 8 (``post_process_flickr``,
   the recall evaluator; #1 12, #3 24 and #6 18 times a forward), images/s
   and a forward's device time by group; the bf16 model against an fp32
   copy on the card at 2 images (row cosine >= 0.99); 3 fine-tuning steps
   after 1 at batch 4 (``mdetr_loss``, the three-group AdamW and its
   schedule; no kernel launches at dropout 0.1), ms a step, peak memory,
   the Hungarian matcher's host ms, a step's device time by group and the
   idle share;
16. MUGEN text-to-video generation at full width (``text_video_gpt``: 128
   BPE tokens over CLIP's 49,408 ids, d_model 768, 8 heads, 12 layers,
   MUGEN's VQ-VAE of 2,048 codes from an (8, 8, 8) latent to 32 x 256 x
   256; bf16 compute, random weights from a seed, ``to_logit`` random):
   16 seeded prompts tokenized with ``clip_merges.bpe``, served through
   ``VideoGPTServer`` on 8 slots (the start row a registered prefix), 512
   new tokens each, half greedy and half sampled; every request must reach
   its length and #3 must launch 12 times a prefill call and a tick
   (asserted on the whole run and on one call of each alone); videos/s,
   decode tokens/s, host and device ms a tick, TTFT p50; the 16 videos
   decoded to (16, 32, 256, 256, 3), finite; ``GenerationUtil.sample`` at
   batch 8 on the same prompts (#3 12 times a step); in fp32 on the card
   the server's greedy tokens equal to ``GenerationUtil``'s on the first
   16 steps; 4 served videos teacher-forced, bf16 logits against fp32 (row
   cosine >= 0.99); a VQ-VAE round trip of 8 clips, timed, with the share
   of codes that bf16 and fp32 agree on; and ``video_gpt`` (16 x 64 x 64
   -> 8 x 32 x 32, d_model 576, 4 heads, 16 layers) teacher-forced at
   batch 1, bf16 against fp32 (row cosine >= 0.99);
17. MDETR VQA fine-tuning (``mdetr_for_vqa`` at the grounding phase's
   widths, the six GQA heads) on seeded GQA-format batches of 4 at 800 x
   1066 / 1066 x 800: ``finetune_vqa`` for 5 steps with EMA (the model
   deterministic, as the JAX loss runs it, so #1, #3 and #6 launch forward
   and #2, #4 and the flash backward backward: ``mdetr_vqa_launches``), ms
   a step, peak memory, the EMA against its chunk formula, a step's device
   time by group and the idle share; ``evaluate_vqa`` over 32 examples; the
   bf16 gradients against an fp32 copy's on the card at the batch of 4
   (cosine >= 0.99);
18. a ``phases:`` line (each phase's wall seconds), a ``kernels`` JSON
   line, the card line, and the result line ``{"ok": true, "device":
   {...}}``.

Phase 2 checks the MLP forward (#3) at the CLIP, LM (prefill, train step,
decode tick), FLAVA and ALBEF (960, 3,840 and 18,464 rows) shapes, every
activation at small widths and 48 to
512 rows, bf16 and fp32, each output element held to its own row's scale
(``row_relative_error``), and a second launch into output and workspace
filled with NaN bitwise equal to the first. It checks the MLP backward
without weight gradients (#4) at CLIP's train step, the gradient checks'
rows (FLAVA's 154-550, the LM's 1,024: dx split over Dff), ALBEF's text
and multimodal rows (960) and its negative pairs' (1,920), and
every activation, relaunched into NaN-filled outputs and workspace,
bitwise equal. It also checks the flash attention forward (#6) at the
prefill shape (8, 12, 2048, 64) causal, a train step's (8, 12, 8192, 64)
with lse, with and without segment ids, the 128-query tile's edges (Sq
127, 129, 191), its masking variants and the CLIP ResNet attention pools
(non-causal at S = 50 with 256 x 32 heads, 82, 145 and 197), ALBEF's
ViT-B/16 at 384 (32, 12, 577, 577, 64) and at 256 (2, 12, 257, 257, 64)
non-causal, and its cross-attention's (32, 12, 30, 577, 64), each
relaunched into an output and lse filled with NaN, bitwise equal, and
times each case against SDPA; and the int8-cache decode
attention (#10) at the decode shape (33 x 12 heads, 4096 positions), its
verify-window and GQA variants, a query row that sees nothing, 8 query
rows over 8,192 positions and one over 32,768, each output element held to
its own row's scale (``row_relative_error``) and relaunched into an output
and scratch filled with NaN, bitwise equal, its time the profiler's device
time; and #6 against the plain path at S = 32 to 1024 (the numbers
``ops/attention.py:FLASH_MIN_SEQ`` is set from). It checks the flash
attention backward (``flash_attention_bwd``: #7 dq and #8 dk/dv as one
call; #9 the bias gradient) against the plain backward at the prefill
shape causal and #6's variants, bf16 and fp32, with
the lse cotangent through ``flash_attention_lse``, and at ALBEF's ViT
shapes non-causal, (32, 12, 577, 577, 64) and (2, 12, 257, 257, 64), timed
in bf16 beside the SDPA backward and the bound, each element to its
row's scale, and launches it again into outputs and a dq workspace filled
with NaN (dk and dv bitwise equal, dq within its bar); and times the call
and #9 at the LM training shape (8, 12, 8192, 64) bf16 causal beside their
bound, the plain version and the SDPA backward (for #9 with a
differentiable float mask, whose gradient is ds). It checks the MLP
backward with weight gradients (#5) against its plain version at every
activation, the CLIP, FLAVA and LM train steps' shapes, bf16 and fp32
(dx to #4's bar, the fp32 dW1, dW2 and db1 to their own scale, two
launches bitwise equal), and times it, and each of its stages (z/dh, dx,
dW, sum, from the profiler), beside its bound, the library's recompute VJP
and the route it replaces (#4 plus the library's dW products); and times
#5 against that route at 256 to 65,536 rows (the numbers
``fused_mlp_bwd_acc_supported``'s threshold is set from, the paths' own row
counts above 16,384: ALBEF's 18,464, CLIP text's 19,712, ViT-B/16's 50,432,
the LM's 65,536; the train phases' expected launches of #4 and #5 follow
that predicate), #5 also at ALBEF's 18,464 rows; and times #6 against the
plain path at ALBEF's cross-attention shape, forward and forward +
backward. CoCa's and BLIP-2's shapes: #1 and #2 at (32, 256, 3 x 1024),
16 heads; #6 and the flash backward on the bias route at CoCa's text
decoder (32, 12, 77, 77, 64) with its causal-and-padding mask, its fusion
self-attention (32, 12, 76, 76, 64) causal-masked and BLIP-2's captioning
pass (128, 12, 32, 64, 64) with the -10000 mask, at head width 96 (the
pooler, (32, 8, 256, 256, 96)), at the cross-attentions (32, 12, 76, 256,
64) and (128, 12, 32, 257, 64), #6 at BLIP-2's tower (128, 16, 257, 257,
64), and #10 over the caption caches (33 x 12 heads over 76 and 64
positions), each relaunched into NaN-filled outputs and timed as above.
#6's `wgmma` kernel's bias lane and head width 96 also at a BERT-style
(B, 1, 1, Sk) key-padding bias, a query row the bias masks wholly (the
mean of V, not 0), a ragged Sq = 77 at D = 96 with lse, D = 96 causal,
and D = 96 with a bias in blocks of two warpgroups (300 queries) and of
one (48 queries, a row masked wholly).
Slice 10's shapes (``check_slice10_kernels``): #6 at head width 32 (the
`wgmma` kernel) at MDETR's encoder self-attention (8, 8, 1220, 1220)
and cross-attention (8, 8, 100, 1220), their key padding as segment ids
(queries 1, keys by the mask), and its decoder self-attention (8, 8, 100,
100); #1 at MUGEN's text tower (16, 32, 3 x 768) and MDETR's RoBERTa (8,
64, 3 x 768) with their key biases; #3 with ReLU at MDETR's encoder (9,760
rows) and decoder (800) MLPs, 256 -> 2048 -> 256, and with exact GELU at
the text towers' 512 rows. Slice 11's (``check_slice11_kernels``): #3 with
quick-GELU at MUGEN text-to-video's GPT MLP (768 -> 3,072 -> 768) at a
serving tick (9 rows), a sampler step (8) and the prefill bucket (1,024),
and at VideoGPT's (576 -> 2,304 -> 576) teacher-forced 16,384 rows; and
MDETR VQA fine-tuning's kernels at its batch of 4, forward and backward:
#6 and the flash backward at head width 32 (the backward on `mma.sync`)
at (4, 8, 1220, 1220) and (4, 8, 100, 1220) with key padding as segment
ids and at (4, 8, 100, 100), #1 and #2 at RoBERTa's (4, 64, 3 x 768) with
its key bias, #3 and #4 at 4,880 and 400 rows of 256 -> 2048 -> 256 ReLU
and 256 rows of 768 -> 3,072 -> 768 exact GELU.
The fp32 cases of #6 and of the flash backward are held against the plain
version run in float64 on the card, to their bar or to twice the plain
fp32 version's own distance from float64, whichever is larger, and run
again on the inputs of two more seeds (``FP32_SEEDS``); the bf16 cases
against the plain version in bf16, as before.
``--kernels-only`` stops after phase 2 and prints no result line;
``--planted-faults`` only builds copies of #1, #2, #6, the flash backward,
#4, #5, #3 and #10 with known faults (``PLANTED_FAULTS``) and shows that
the checks catch each one; ``--ab PARENT`` only times #1-#6 and #10 at
their paths' shapes, the flash attention backward at the LM training shape,
CoCa's fusion self-attention both ways and the LM serving tick of the tree at
PARENT (the parent commit unpacked with ``git archive``) and of this
checkout, in turns, each in a process of its own, after comparing the two
trees' flash attention kernels by their SASS.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / fp32 non-tensor
BATCH = 512
TRAIN_BATCH = 256  # bench.py's TRAIN_BATCH


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, stdout=subprocess.PIPE, text=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if len(out) > 1 else out[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, group: Optional[str], calls: int = 20) -> float:
    """Device time of one ``fn()`` in ms: its kernels of ``kernel_group``
    ``group`` (every kernel with None) under torch.profiler, summed over
    ``calls`` calls and divided by them (for a call whose host time exceeds
    its device time, which the events of ``time_ms`` would measure
    instead); NaN when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in prof.key_averages()
             if group is None or kernel_group(e.key) == group)
    return us / 1e3 / calls if us else float("nan")


def kernel_names(fn) -> list:
    """The names of the kernels one ``fn()`` launches, from torch.profiler
    (none when it sees no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:80] for e in prof.key_averages()
                   if (getattr(e, "self_device_time_total", 0) or 0) > 0})


def fwd_route(fa, dtype: torch.dtype, d: int) -> str:
    """Kernel #6's kernel at head width ``d`` in ``dtype``, as its C entry
    chooses it (``mm_flash_attention_fwd_route``)."""
    return ("fp32 pipes", "mma.sync", "wgmma")[
        fa._kernels().mm_flash_attention_fwd_route(d, fa._DTYPE_CODES[dtype])]


def dbias_route(dtype: torch.dtype, d: int) -> str:
    """Kernel #9's kernel at head width ``d`` in ``dtype``, as
    ``mm_flash_attention_bwd_dbias`` chooses it."""
    if dtype != torch.bfloat16:
        return "fp32 pipes"
    return "wgmma" if d in (32, 64, 96) else "mma.sync" if d == 128 else "fp32 pipes"


def bwd_route(fa, dtype: torch.dtype, d: int) -> str:
    """The flash backward's kernels for dq, dk and dv at head width ``d`` in
    ``dtype``, as its C entry chooses them (``mm_flash_attention_bwd_route``)."""
    return ("fp32 pipes", "mma.sync", "wgmma")[
        fa._kernels().mm_flash_attention_bwd_route(d, fa._DTYPE_CODES[dtype])]


def tolerance(dtype: torch.dtype, ref: torch.Tensor) -> float:
    """bf16: two units in the last place of the largest output (one rounding
    of the output landing on the other side of a tie, plus probabilities or
    intermediates rounded to bf16 at a different tie); fp32: 1e-4 of the
    output scale (the same products summed in another order, up to 3072
    terms)."""
    scale = max(1.0, ref.abs().max().item())
    return (2.0 ** -6 if dtype == torch.bfloat16 else 1e-4) * scale


def row_relative_error(got: torch.Tensor, ref: torch.Tensor,
                       terms: Optional[torch.Tensor] = None,
                       keep: Optional[torch.Tensor] = None) -> float:
    """Largest |got - ref| / (|ref| + rms of ref's row) over the elements, a
    row being the last dimension (one query row of one head). Each element
    is held to its own row's scale, so the rows that see few keys (outputs
    up to 4) do not loosen the bar for rows that see thousands (outputs near
    0.03), as a bar scaled by the largest output would. With ``terms`` (each
    element's sum over the absolute values of its terms) the denominator
    gains 2^-8 of the element's terms: an element whose exact value is 0 (in
    the attention backward the first causal query row, ds_00 = dp_00 -
    delta_0 with o_0 = v_0) holds only the rounding noise of a cancellation,
    whose scale is that of its terms, not of the result. With ``keep`` only
    the elements where it is true count."""
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    denom = r.abs() + r.pow(2).mean(-1, keepdim=True).sqrt()
    if terms is not None:
        denom = denom + 2.0 ** -8 * terms.float()
    rel = torch.where(err == 0, 0.0, err / denom)
    if keep is not None:
        rel = torch.where(keep, rel, 0.0)
    return rel.max().item()


# Bars of row_relative_error for kernels #6 and #10. bf16: 2^-6, two units in
# the last place of the element (kernel and plain version each round the
# output once, and round the probabilities to bf16 at points that can fall
# on opposite sides of a tie). fp32: #6 rounds nothing to bf16, so only the
# order of the sums differs; #10 rounds p x v_scale to bf16 on both sides
# (as the TPU kernel does), so a score summed in another order can move one
# of those roundings across a tie.
ROW_RELATIVE_BAR = {
    ("flash_attention", torch.bfloat16): 2.0 ** -6,
    ("flash_attention", torch.float32): 2.0 ** -15,
    ("quantized_cache_attention", torch.bfloat16): 2.0 ** -6,
    ("quantized_cache_attention", torch.float32): 2.0 ** -9,
}


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def slice_gen(dtype: torch.dtype) -> torch.Generator:
    """The generator of the caption slice's phase-2 cases in ``dtype``:
    apart from the earlier cases' generators, whose inputs stay those of
    the runs their readings come from."""
    return torch.Generator(device="cuda").manual_seed(14 if dtype == torch.bfloat16 else 15)


def reps_for(ms_guess: float) -> int:
    return max(3, min(50, int(300 / max(ms_guess, 1e-3))))


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


def _attention_inputs(b, s, d, dtype, key_bias, gen):
    """#1's qkv and, with ``key_bias``, a (B, S) bias masking each key of a
    row's second half with probability 1/2 (-1e30); with ``key_bias`` =
    "masked_prefix", the bias masks keys [0, 100) of every other batch row,
    so that under the causal mask queries 0-99 of those rows see masked keys
    only (the TPU kernel's softmax is then uniform over all S keys)."""
    qkv = torch.randn(b, s, 3 * d, device="cuda", generator=gen).to(dtype)
    kb = None
    if key_bias == "masked_prefix":
        kb = torch.zeros(b, s, device="cuda")
        kb[::2, :100] = -1e30
    elif key_bias:
        kb = torch.zeros(b, s, device="cuda")
        kb[:, s // 2:] = torch.where(
            torch.rand(b, s - s // 2, device="cuda", generator=gen) < 0.5, -1e30, 0.0)
    return qkv, kb


def attention_case(fe, name, b, s, d, h, causal, dtype, key_bias, gen, timing=True):
    """Kernel #1 against its plain version by max abs error
    (``tolerance``), and a second launch into an output filled with NaN,
    bitwise equal to the first; with ``timing``, its time beside its bound,
    the plain version and SDPA."""
    qkv, kb = _attention_inputs(b, s, d, dtype, key_bias, gen)
    with torch.inference_mode():
        out = fe.fused_qkv_attention(qkv, h, causal, None, kb)
        ref = fe.qkv_attention_plain(qkv, h, causal, None, kb)
        # the same launch into NaN: an element the kernel does not write shows
        again = torch.full_like(out, math.nan)
        fe._attention_fwd_launch(qkv, h, causal, None, kb, again)
        torch.cuda.synchronize()
        deterministic = torch.equal(out, again)
        del again
        err = (out.float() - ref.float()).abs().max().item()
        tol = tolerance(dtype, ref)
        row = dict(kernel="fused_qkv_attention", case=name, shape=[b, s, 3 * d], heads=h,
                   causal=causal, key_bias=key_bias, dtype=str(dtype).replace("torch.", ""),
                   max_abs_err=err, tol=tol, deterministic=deterministic,
                   ok=bool(err <= tol and deterministic))
        if not timing:
            return row
        kernel_ms = time_ms(lambda: fe.fused_qkv_attention(qkv, h, causal, None, kb), 1)
        reps = reps_for(kernel_ms)
        kernel_ms = time_ms(lambda: fe.fused_qkv_attention(qkv, h, causal, None, kb), reps)
        plain_ms = time_ms(lambda: fe.qkv_attention_plain(qkv, h, causal, None, kb), reps)
        q, k, v = qkv.view(b, s, 3, h, d // h).permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        mask = None
        if kb is not None:
            mask = kb[:, None, None, :]
            if causal:
                mask = mask + torch.full((s, s), -1e30, device="cuda").triu(1)
            mask = mask.to(dtype)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask, is_causal=causal and mask is None)
        lib_ms = time_ms(lib, reps)
        # the profiler's device time: at small shapes the events time the
        # wrappers' host work
        dev_ms = device_ms(lambda: fe.fused_qkv_attention(qkv, h, causal, None, kb), None)
        lib_dev_ms = device_ms(lib, None)
    es = qkv.element_size()
    nbytes = qkv.numel() * es + out.numel() * es + (0 if kb is None else kb.numel() * 4)
    pairs = s * (s + 1) // 2 if causal else s * s  # (query, key) products the mask leaves
    flops = 4.0 * b * h * pairs * (d // h)
    bms, by = bound_ms(nbytes, flops, dtype)
    row.update(ms=kernel_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
               device_ms=dev_ms, library_device_ms=lib_dev_ms)
    return row


# Kernel #1's cases: CLIP ViT-B/32's towers at the serving batch, the
# key-bias lane, head width 96, ALBEF's text tower at its train batch (its
# padding bias), on one generator (seed 0) in this order.
ATTENTION_CASES = [
    ("vision", BATCH, 50, 768, 12, False, False),
    ("text", BATCH, 77, 512, 8, True, False),
    ("key_bias", 8, 40, 256, 4, False, True),
    ("key_bias_causal", 8, 77, 256, 4, True, True),
    ("head_width_96", 8, 50, 384, 4, True, False),
    ("albef_text", 32, 30, 768, 12, False, True),
]
# CoCa ViT-L/14's vision tower at the train batch (256 tokens, no CLS), on
# the caption slice's generator (``slice_gen``)
CAPTION_ATTENTION_CASES = [("coca_vit_l14", 32, 256, 1024, 16, False, False)]
# The `wgmma` route's edges, on generators of their own (``route_gen``): a
# key bias under the causal mask at S = 256 (four key chunks), a ragged
# S = 193 (a last query tile of one row, a last key chunk of one key), and
# causal rows whose every visible key the bias masks at S = 256 (their
# query tiles skip the key chunks past them, whose keys still count).
ROUTE_ATTENTION_CASES = [
    ("key_bias_causal_256", 8, 256, 768, 12, True, True),
    ("ragged_193", 8, 193, 768, 12, False, True),
    ("causal_masked_rows_256", 8, 256, 768, 12, True, "masked_prefix"),
]


def route_gen(dtype: torch.dtype) -> torch.Generator:
    """The generator of the cases added with #1's and #6's `wgmma` routes
    (the forward's key-bias lane and head width 96), apart from the earlier
    cases' generators, whose inputs stay those of the runs their readings
    come from."""
    return torch.Generator(device="cuda").manual_seed(
        1500 if dtype == torch.bfloat16 else 1501)


def check_attention_fwd_kernel(fe, dtypes=(torch.bfloat16, torch.float32), timing=True):
    """Kernel #1 at ``ATTENTION_CASES``, ``CAPTION_ATTENTION_CASES`` and
    ``ROUTE_ATTENTION_CASES`` in each dtype."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in dtypes:
        for cases, g in ((ATTENTION_CASES, gen), (CAPTION_ATTENTION_CASES, slice_gen(dtype)),
                         (ROUTE_ATTENTION_CASES, route_gen(dtype))):
            for name, b, s, d, h, causal, kb in cases:
                rows.append(attention_case(fe, name, b, s, d, h, causal, dtype, kb, g,
                                           timing=timing))
                torch.cuda.empty_cache()
    print("kernel_check tolerance: " + " ".join(tolerance.__doc__.split()), flush=True)
    for c in rows:
        print("kernel_check " + json.dumps(c), flush=True)
    return rows


# Bars of row_relative_error for kernel #3. bf16: 2^-6, two units in the
# last place of the element (kernel and plain version each round h and the
# output once, and an fp32 sum taken in another order can land on the other
# side of a tie). fp32: nothing is rounded to bf16, only the order of the
# sums (up to 3072 terms) differs.
ROW_RELATIVE_BAR_MLP = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -15}
MLP_STAGES = (("h", "fused_mlp_fwd_h"), ("o", "fused_mlp_fwd_o"))


def _mlp_inputs(rows, din, dff, dout, dtype, gen):
    x = torch.randn(rows, din, device="cuda", generator=gen).to(dtype)
    w1t = (torch.randn(dff, din, device="cuda", generator=gen) * din ** -0.5).to(dtype)
    b1 = (torch.randn(dff, device="cuda", generator=gen) * 0.02).to(dtype)
    w2t = (torch.randn(dout, dff, device="cuda", generator=gen) * dff ** -0.5).to(dtype)
    b2 = (torch.randn(dout, device="cuda", generator=gen) * 0.02).to(dtype)
    return x, w1t, b1, w2t, b2


def mlp_case(fe, name, rows, din, dff, dout, act, dtype, gen, timing=True):
    """Kernel #3 against its plain version, each output element to its row's
    scale (``row_relative_error``, ``ROW_RELATIVE_BAR_MLP``), and a second
    launch into an output and a workspace filled with NaN bitwise equal to
    the first: repeatable, and no element of either left unwritten. With
    ``timing``, its time (and its stages' device time) beside its bound, the
    plain version and linear-act-linear."""
    x, w1t, b1, w2t, b2 = _mlp_inputs(rows, din, dff, dout, dtype, gen)
    w1, w2 = w1t.t(), w2t.t()  # (Din, Dff), (Dff, Dout) column-major, as nn.Linear holds them
    lib_act = fe._ACTIVATIONS[act]
    run = lambda: fe.fused_mlp(x, w1, b1, w2, b2, act)  # noqa: E731
    with torch.inference_mode():
        ref = fe.mlp_plain(x, w1, b1, w2, b2, act)
        out = run()
        # the same launch into NaN: an element of the output, or a row of h
        # between the two stages, that the kernel does not write shows as NaN
        # rather than as what the caching allocator's block held before
        again = torch.full_like(out, math.nan)
        ws_shape = fe._mlp_fwd_workspace(rows, dff, dtype)
        ws = None if ws_shape is None else torch.full(ws_shape, math.nan, dtype=dtype,
                                                      device=x.device)
        fe._mlp_fwd_launch(x, w1, b1, w2, b2, act, again, ws)
        torch.cuda.synchronize()
        deterministic = torch.equal(out, again)
        rel = row_relative_error(out, ref)
        err = (out.float() - ref.float()).abs().max().item()
        del again, ws
        bar = ROW_RELATIVE_BAR_MLP[dtype]
        row = dict(kernel="fused_mlp", case=name, shape=[rows, din, dff, dout], activation=act,
                   dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                   rel_err={"out": rel}, tol=bar, deterministic=deterministic,
                   ok=bool(deterministic and rel <= bar))
        if not timing:
            return row
        kernel_ms = time_ms(run, 1)
        reps = reps_for(kernel_ms)
        kernel_ms = time_ms(run, reps)
        plain_ms = time_ms(lambda: fe.mlp_plain(x, w1, b1, w2, b2, act), reps)
        lib_ms = time_ms(lambda: F.linear(lib_act(F.linear(x, w1t, b1)), w2t, b2), reps)
        stages = stage_ms(run, MLP_STAGES)
    es = x.element_size()
    nbytes = (x.numel() + w1.numel() + b1.numel() + w2.numel() + b2.numel() + rows * dout) * es
    flops = 2.0 * rows * (din * dff + dff * dout)
    bms, by = bound_ms(nbytes, flops, dtype)
    row.update(ms=kernel_ms, stage_ms=stages, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bms, bound_by=by,
               tflops=flops / kernel_ms / 1e9, gbps=nbytes / kernel_ms / 1e6)
    return row


def check_mlp_kernel(fe, dtypes=(torch.bfloat16, torch.float32), timing=True):
    """Kernel #3 at the paths' shapes in each dtype: CLIP ViT-B/32 serving
    (batch 512), every activation at small widths (Dout 192 leaves a ragged
    column tile), the LM's prefill call, train step and decode tick, the
    few rows between those two (48 to 512), FLAVA's three MLPs at batch
    64, and ALBEF's at batch 32 and in its rerank."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = [("vision", BATCH * 50, 768, 3072, 768, "quick_gelu"),
              ("text", BATCH * 77, 512, 2048, 512, "quick_gelu")]
    shapes += [(f"small_{act}", 300, 256, 512, 192, act)
               for act in ("quick_gelu", "gelu", "gelu_exact", "relu", "silu")]
    # the LM's MLP (exact GELU): a prefill call of 8 x 2048 rows, a train
    # step's 8 x 8192, a decode tick of 33, and few rows in between
    shapes += [(name, r, 768, 3072, 768, "gelu_exact") for name, r in (
        ("lm_prefill", 8 * 2048), ("lm_train", 8 * 8192), ("lm_decode", 33),
        ("rows_48", 48), ("rows_64", 64), ("rows_128", 128), ("rows_256", 256),
        ("rows_512", 512))]
    shapes += [(f"flava_{tower}", FLAVA_BATCH * seq, 768, 3072, 768, "gelu_exact")
               for tower, seq in FLAVA_SEQS]
    # ALBEF at batch 32: the text and multimodal towers (960 rows), the
    # rerank's multimodal calls (128 x 30) and the ViT at 384 (18,464)
    shapes += [(name, r, 768, 3072, 768, "gelu_exact") for name, r in (
        ("albef_text", ALBEF_BATCH * ALBEF_TEXT), ("albef_rerank", ALBEF_K_TEST * ALBEF_TEXT),
        ("albef_vit", ALBEF_BATCH * ALBEF_SEQ))]
    rows = []
    for dtype in dtypes:
        for shape in shapes:
            row = mlp_case(fe, *shape, dtype, gen, timing=timing)
            print("kernel_check " + json.dumps(row), flush=True)
            rows.append(row)
            torch.cuda.empty_cache()
    return rows


def _attention_bwd_inputs(b, s, d, dtype, key_bias, gen):
    """#2's qkv, g and key bias (as ``_attention_inputs``'s, "masked_prefix"
    too)."""
    qkv = torch.randn(b, s, 3 * d, device="cuda", generator=gen).to(dtype)
    g = torch.randn(b, s, d, device="cuda", generator=gen).to(dtype)
    kb = None
    if key_bias == "masked_prefix":
        kb = torch.zeros(b, s, device="cuda")
        kb[::2, :100] = -1e30
    elif key_bias:
        kb = torch.zeros(b, s, device="cuda")
        kb[:, s // 2:] = torch.where(
            torch.rand(b, s - s // 2, device="cuda", generator=gen) < 0.5, -1e30, 0.0)
    return qkv, g, kb


def attention_bwd_case(fe, name, b, s, d, h, causal, dtype, key_bias, gen, timing=True,
                       route=None):
    """Kernel #2 against its plain version by max abs error (``tolerance``),
    a key the bias masks getting dk = dv = 0 exactly, and a second launch
    through ``_attention_bwd_launch`` into a dqkv filled with NaN, bitwise
    equal to the first (every element written, in a fixed order). With
    ``route`` both launches go to that kernel (``fe._BWD_*``) instead of
    the dispatch's. Under "masked_prefix" the masked keys are seen, by the
    causal rows whose every visible key the bias masks (their p is uniform
    over all S keys), so their dk and dv are not 0 and are not checked so;
    those rows' dq and every key's dv are held to ``MASKED_ROWS_BAR`` by
    ``row_relative_error`` besides."""
    qkv, g, kb = _attention_bwd_inputs(b, s, d, dtype, key_bias, gen)
    forced = route is not None
    if not forced:
        route = fe._attention_bwd_route(s, d // h, dtype)

    def call():
        if not forced:
            return fe.fused_qkv_attention_bwd(qkv, g, h, causal, None, kb)
        dqkv = torch.empty_like(qkv)
        fe._attention_bwd_launch(qkv, g, h, causal, None, kb, dqkv, route)
        return dqkv

    out = call()
    ref = fe.qkv_attention_bwd_plain(qkv, g, h, causal, None, kb)
    again = torch.full_like(out, float("nan"))
    fe._attention_bwd_launch(qkv, g, h, causal, None, kb, again, route)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = tolerance(dtype, ref)
    deterministic = bool(torch.equal(out, again))
    # a key masked by the bias is seen by no query: its dk and dv are exactly 0
    masked_zero = (kb is None or key_bias == "masked_prefix"
                   or bool((out[..., d:][kb < -1e29] == 0).all()))
    row = dict(kernel="fused_qkv_attention_bwd", case=name, shape=[b, s, 3 * d], heads=h,
               causal=causal, key_bias=key_bias, dtype=str(dtype).replace("torch.", ""),
               route=route, max_abs_err=err, tol=tol, masked_keys_zero=masked_zero,
               deterministic=deterministic, ok=bool(err <= tol and masked_zero and deterministic))
    if key_bias == "masked_prefix":
        # The rows the bias masks wholly hold small values (p = 1 / S), far
        # below the largest output that ``tolerance`` scales with: each
        # element to its own row's scale (``row_relative_error``, a row one
        # head's Dh values) over those rows' dq, and over every key's dv,
        # which takes their p.
        view = lambda t: t.float().view(b, s, 3, h, d // h)  # noqa: E731
        rows = (kb < -1e29)[:, :, None, None].expand(b, s, h, d // h)
        rel = max(row_relative_error(view(out)[:, :, 0], view(ref)[:, :, 0], keep=rows),
                  row_relative_error(view(out)[:, :, 2], view(ref)[:, :, 2]))
        row.update(masked_rows_rel_err=rel, masked_rows_bar=MASKED_ROWS_BAR[dtype])
        row["ok"] = row["ok"] and rel <= MASKED_ROWS_BAR[dtype]
    if not timing:
        return row
    kernel_ms = time_ms(call, 1)
    reps = reps_for(kernel_ms)
    kernel_ms = time_ms(call, reps)
    plain_ms = time_ms(lambda: fe.qkv_attention_bwd_plain(qkv, g, h, causal, None, kb), reps)
    q, k, v = (t.detach().requires_grad_() for t in
               qkv.view(b, s, 3, h, d // h).permute(2, 0, 3, 1, 4).contiguous().unbind(0))
    go = g.view(b, s, h, d // h).transpose(1, 2).contiguous()
    mask = None
    if kb is not None:
        mask = kb[:, None, None, :]
        if causal:
            mask = mask + torch.full((s, s), -1e30, device="cuda").triu(1)
        mask = mask.to(dtype)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=causal and mask is None)
    lib_ms = time_ms(lambda: torch.autograd.grad(o, (q, k, v), go, retain_graph=True), reps)
    es = qkv.element_size()
    nbytes = (qkv.numel() + g.numel() + out.numel()) * es + (0 if kb is None else kb.numel() * 4)
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 10.0 * b * h * pairs * (d // h)  # five S x S x Dh products
    bms, by = bound_ms(nbytes, flops, dtype)
    row.update(ms=kernel_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by)
    return row


# Kernel #2's cases: CLIP ViT-B/32's towers at the train batch, the key-bias
# lane, head width 96, and past S = 128 (the `wgmma` route): one past it,
# ViT-B/16's vision tower at the train batch, S = 256 at head width 64 and
# S = 181 at 128 (the forward's largest there), each with the masks; ALBEF's
# text tower at batch 32 (S = 30, its padding bias).
ATTENTION_BWD_CASES = [
    ("vision", TRAIN_BATCH, 50, 768, 12, False, False),
    ("text", TRAIN_BATCH, 77, 512, 8, True, False),
    ("key_bias", 8, 40, 256, 4, False, True),
    ("key_bias_causal", 8, 77, 256, 4, True, True),
    ("head_width_96", 8, 50, 384, 4, True, False),
    ("seq_129", 8, 129, 768, 12, True, True),
    ("vit_b16", TRAIN_BATCH, 197, 768, 12, False, False),
    ("seq_256", 8, 256, 768, 12, True, True),
    ("head_width_128_seq_181", 8, 181, 512, 4, True, True),
    ("albef_text", 32, 30, 768, 12, False, True),
]
# CoCa ViT-L/14's vision tower at the train batch, on generators of
# its own (``slice_gen``): the cases above keep their inputs
CAPTION_ATTENTION_BWD_CASES = [("coca_vit_l14", 32, 256, 1024, 16, False, False)]
# Bars of #2's reading of the wholly masked rows (``attention_bwd_case``):
# bf16 2^-6, two units in the last place of the element, as the flash
# kernels' bars; fp32 2^-10, loose against the sums' order (the rows'
# values to 2^-20) and tight against a fault, which moves them by their
# own size.
MASKED_ROWS_BAR = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -10}
# Causal rows whose every visible key the bias masks ("masked_prefix": their
# p is uniform over all S keys, the keys above the diagonal too) on each of
# #2's kernels, forced: the `wgmma` and FP32-pipe kernels at S = 256, the
# `mma.sync` one at its largest S, 128; the FP32 pipes alone in fp32. Then
# ragged forms on the tensor-core kernels, whose padded keys (past S, up to
# the kernel's padded length) must stay out of those rows' p: `wgmma` at
# S = 200 (its 256-row instance with 112-key tiles) and `mma.sync` at
# S = 120 (its 128-row tiles). On generators of their own (``route_gen``),
# so the cases above keep their inputs.
ROUTE_ATTENTION_BWD_CASES = [
    ("causal_masked_rows_256", 8, 256, 768, 12, True, "masked_prefix", "_BWD_WGMMA"),
    ("causal_masked_rows_128", 8, 128, 768, 12, True, "masked_prefix", "_BWD_MMA"),
    ("causal_masked_rows_256", 8, 256, 768, 12, True, "masked_prefix", "_BWD_FP32_PIPES"),
    ("causal_masked_rows_200", 8, 200, 768, 12, True, "masked_prefix", "_BWD_WGMMA"),
    ("causal_masked_rows_120", 8, 120, 768, 12, True, "masked_prefix", "_BWD_MMA"),
]


def check_attention_bwd_kernel(fe, dtypes=(torch.bfloat16, torch.float32), timing=True):
    """Kernel #2 at ``ATTENTION_BWD_CASES``, ``CAPTION_ATTENTION_BWD_CASES``
    and, on the kernels each names, ``ROUTE_ATTENTION_BWD_CASES`` (the
    tensor-core kernels in bf16 only) in each dtype."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for dtype in dtypes:
        runs = [(name, b, s, d, h, causal, kb, g, None)
                for cases, g in ((ATTENTION_BWD_CASES, gen),
                                 (CAPTION_ATTENTION_BWD_CASES, slice_gen(dtype)))
                for name, b, s, d, h, causal, kb in cases]
        g = route_gen(dtype)
        runs += [(f"{name}/{route[5:].lower()}", b, s, d, h, causal, kb, g, getattr(fe, route))
                 for name, b, s, d, h, causal, kb, route in ROUTE_ATTENTION_BWD_CASES
                 if dtype == torch.bfloat16 or route == "_BWD_FP32_PIPES"]
        for name, b, s, d, h, causal, kb, g, route in runs:
            row = attention_bwd_case(fe, name, b, s, d, h, causal, dtype, kb, g,
                                     timing=timing, route=route)
            print("kernel_check " + json.dumps(row), flush=True)
            rows.append(row)
            torch.cuda.empty_cache()
    return rows


def attention_bwd_routes(fe, shapes=tuple((TRAIN_BATCH, s, 768, 12, False)
                                           for s in (16, 33, 50, 64, 80, 81, 96, 112, 128))
                         + ((TRAIN_BATCH, 77, 512, 8, True),)):
    """Kernel #2's two bf16 routes at head width 64 on the same inputs, at
    S <= 128 where both take the shape (CLIP's vision S = 50 and causal text
    S = 77 among them; the `mma.sync` kernel's tiles change at 64 and 80):
    each held to the bar, and timed. The numbers ``_BWD_WGMMA_MIN_SEQ`` is
    set from."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for b, s, d, h, causal in shapes:
        qkv, g, _ = _attention_bwd_inputs(b, s, d, torch.bfloat16, False, gen)
        ref = fe.qkv_attention_bwd_plain(qkv, g, h, causal)
        row = {"seq": s, "causal": causal}
        for name, route in (("mma", fe._BWD_MMA), ("wgmma", fe._BWD_WGMMA)):
            out = torch.empty_like(qkv)
            fn = lambda: fe._attention_bwd_launch(qkv, g, h, causal, None, None, out, route)  # noqa: E731
            fn()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if not err <= tolerance(torch.bfloat16, ref):
                fail(f"#2 route {name} at S = {s}: max abs error {err}")
            row[f"{name}_ms"] = time_ms(fn, reps_for(time_ms(fn, 1)))
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def _mlp_bwd_inputs(rows, din, dff, dout, dtype, gen):
    x = torch.randn(rows, din, device="cuda", generator=gen).to(dtype)
    g = (torch.randn(rows, dout, device="cuda", generator=gen) * 0.1).to(dtype)
    w1t = (torch.randn(dff, din, device="cuda", generator=gen) * din ** -0.5).to(dtype)
    b1 = (torch.randn(dff, device="cuda", generator=gen) * 0.02).to(dtype)
    w2t = (torch.randn(dout, dff, device="cuda", generator=gen) * dff ** -0.5).to(dtype)
    return x, g, w1t, b1, w2t


MLP_BWD_STAGES = (("zdh", "fused_mlp_bwd_zdh"), ("dx", "fused_mlp_bwd_dx_kernel"),
                  ("sum", "fused_mlp_bwd_dx_sum"))


def mlp_bwd_case(fe, name, rows, din, dff, dout, act, dtype, gen, timing=True):
    """Kernel #4 against its plain version (dx, da and h each to its own
    tolerance), and a second launch into outputs and a workspace filled
    with NaN bitwise equal to the first; with ``timing``, its time (and its
    stages', from the profiler) beside its bound, the plain version and the
    library's recompute VJP."""
    x, g, w1t, b1, w2t = _mlp_bwd_inputs(rows, din, dff, dout, dtype, gen)
    b2 = torch.zeros(dout, device="cuda", dtype=dtype)
    w1, w2 = w1t.t(), w2t.t()
    outs = fe.fused_mlp_bwd(x, g, w1, b1, w2, act)
    refs = fe.mlp_bwd_plain(x, g, w1, b1, w2, act)
    # the same launch into NaN: an element of dx, da or h, or of a dx
    # partial, that the kernel does not write shows as NaN
    again = [torch.full_like(o, math.nan) for o in outs]
    ws = fe._mlp_bwd_workspace(rows, din, dff, dtype)
    part = None if ws is None else torch.full(ws, math.nan, device="cuda")
    fe._mlp_bwd_launch(x, g, w1, b1, w2, act, *again, part)
    torch.cuda.synchronize()
    deterministic = all(torch.equal(o, a) for o, a in zip(outs, again))
    del again, part
    errs = [(o.float() - r.float()).abs().max().item() for o, r in zip(outs, refs)]
    tols = [tolerance(dtype, r) for r in refs]
    worst = max(range(3), key=lambda i: errs[i] / tols[i])  # each output has its own tolerance
    row = dict(kernel="fused_mlp_bwd", case=name, shape=[rows, din, dff, dout], activation=act,
               dtype=str(dtype).replace("torch.", ""),
               splits=1 if ws is None else ws[0], max_abs_err=errs[worst], tol=tols[worst],
               max_abs_err_dx_da_h=errs, tol_dx_da_h=tols, deterministic=deterministic,
               ok=deterministic and all(e <= t for e, t in zip(errs, tols)))
    if not timing:
        return row
    kernel_ms = time_ms(lambda: fe.fused_mlp_bwd(x, g, w1, b1, w2, act), 1)
    reps = reps_for(kernel_ms)
    kernel_ms = time_ms(lambda: fe.fused_mlp_bwd(x, g, w1, b1, w2, act), reps)
    stages = stage_ms(lambda: fe.fused_mlp_bwd(x, g, w1, b1, w2, act), MLP_BWD_STAGES)
    plain_ms = time_ms(lambda: fe.mlp_bwd_plain(x, g, w1, b1, w2, act), reps)
    lib_act = fe._ACTIVATIONS[act]
    xg = x.detach().requires_grad_()
    # the recompute VJP: forward again, then autograd back to x
    lib_ms = time_ms(lambda: torch.autograd.grad(
        F.linear(lib_act(F.linear(xg, w1t, b1)), w2t, b2), xg, g), reps)
    es = x.element_size()
    nbytes = (x.numel() + g.numel() + w1.numel() + b1.numel() + w2.numel()
              + sum(o.numel() for o in outs)) * es
    flops = 2.0 * rows * dff * (2 * din + dout)
    bms, by = bound_ms(nbytes, flops, dtype)
    row.update(ms=kernel_ms, stage_ms=stages, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bms, bound_by=by)
    return row


def check_mlp_bwd_kernel(fe, dtypes=(torch.bfloat16, torch.float32), timing=True):
    """Kernel #4 in each dtype at CLIP ViT-B/32's train-step MLPs (batch
    256), every activation at small widths (Dout 192: a ragged column tile;
    Dff 512: dx in two runs), the gradient checks' rows (FLAVA's at 2
    pairs and the LM's packed row), and ALBEF's retrieval step's text and
    multimodal rows at batch 32."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    tb = TRAIN_BATCH
    shapes = [("vision", tb * 50, 768, 3072, 768, "quick_gelu"),
              ("text", tb * 77, 512, 2048, 512, "quick_gelu")]
    shapes += [(f"small_{act}", 300, 256, 512, 192, act)
               for act in ("quick_gelu", "gelu", "gelu_exact", "relu", "silu")]
    # FLAVA's gradient check at 2 pairs, #4's side of the predicate, and the
    # LM's at one packed row of 1,024 tokens
    shapes += [(f"flava_grad_{tower}", 2 * seq, 768, 3072, 768, "gelu_exact")
               for tower, seq in FLAVA_SEQS]
    shapes.append(("lm_grad", 1024, 768, 3072, 768, "gelu_exact"))
    # ALBEF's retrieval step at batch 32: the text and multimodal towers
    # (960 rows), the negative pairs' multimodal pass (1,920)
    shapes += [("albef_text", ALBEF_BATCH * ALBEF_TEXT, 768, 3072, 768, "gelu_exact"),
               ("albef_negatives", 2 * ALBEF_BATCH * ALBEF_TEXT, 768, 3072, 768, "gelu_exact")]
    rows = []
    for dtype in dtypes:
        for shape in shapes:
            row = mlp_bwd_case(fe, *shape, dtype, gen, timing=timing)
            print("kernel_check " + json.dumps(row), flush=True)
            rows.append(row)
            torch.cuda.empty_cache()
    return rows


# Bars of row_relative_error (each element's terms included) for the fp32
# dW1, dW2 and db1 of kernel #5, keyed on the input dtype. bf16: 2^-6, as
# for #6: da and h are rounded to bf16 before the dW products, and an fp32
# value summed in another order can land on the other side of a tie. fp32:
# nothing is rounded to bf16, only the order of the sums over the rows
# differs. Where a weight gradient's terms cancel (random data: an element
# of dW1 is a sum of thousands of terms of either sign), 2^-8 of its terms
# join its scale, as for the flash backward.
ROW_RELATIVE_BAR_ACC = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -15}


def mlp_bwd_acc_case(fe, name, rows, din, dff, dout, act, dtype, gen, timing=True):
    """Kernel #5 against its plain version: dx to #4's bar, dW1, dW2 and db1
    to their own scale (``ROW_RELATIVE_BAR_ACC``); two launches bitwise
    equal; with ``timing``, its time beside its bound, the plain version,
    the library's recompute VJP (autograd through F.linear, the activation
    and F.linear, every gradient) and the route it replaces (#4 plus its two
    library dW products and the db1 sum)."""
    x, g, w1t, b1, w2t = _mlp_bwd_inputs(rows, din, dff, dout, dtype, gen)
    w1, w2 = w1t.t(), w2t.t()
    outs = fe.fused_mlp_bwd_acc(x, g, w1, b1, w2, act)
    again = fe.fused_mlp_bwd_acc(x, g, w1, b1, w2, act)
    refs = fe.mlp_bwd_acc_plain(x, g, w1, b1, w2, act)
    torch.cuda.synchronize()
    deterministic = all(torch.equal(a, b) for a, b in zip(outs, again))
    # each dW element's terms: |x|^T |da_c|, |h_c|^T |g|; db1's: sum of |da|
    z = x.float() @ w1.float() + b1.float()
    h, dact = fe._act_and_grad(act, z)
    da = (g.float() @ w2.float().t()) * dact
    terms = (x.float().abs().t() @ da.to(dtype).float().abs(),
             h.to(dtype).float().abs().t() @ g.float().abs(), da.abs().sum(0))
    del z, h, dact, da
    dx_err = (outs[0].float() - refs[0].float()).abs().max().item()
    dx_tol = tolerance(dtype, refs[0])
    rel = {n: row_relative_error(o, r, t)
           for n, o, r, t in zip(("dw1", "dw2", "db1"), outs[1:], refs[1:], terms)}
    bar = ROW_RELATIVE_BAR_ACC[dtype]
    ok = dx_err <= dx_tol and all(v <= bar for v in rel.values()) and deterministic
    row = dict(kernel="fused_mlp_bwd_acc", case=name, shape=[rows, din, dff, dout],
               activation=act, dtype=str(dtype).replace("torch.", ""),
               splits=fe._acc_splits(rows, din, dff, dout), max_abs_err=dx_err, tol=dx_tol,
               rel_err=rel, rel_bar=bar, deterministic=deterministic, ok=bool(ok))
    del outs, again, refs, terms
    if not timing:
        return row
    kernel_ms = time_ms(lambda: fe.fused_mlp_bwd_acc(x, g, w1, b1, w2, act), 1)
    reps = reps_for(kernel_ms)
    kernel_ms = time_ms(lambda: fe.fused_mlp_bwd_acc(x, g, w1, b1, w2, act), reps)
    stages = stage_ms(lambda: fe.fused_mlp_bwd_acc(x, g, w1, b1, w2, act), ACC_STAGES)
    plain_ms = time_ms(lambda: fe.mlp_bwd_acc_plain(x, g, w1, b1, w2, act), reps)

    def staged():  # the route #5 replaces: _MLP.backward's #4 branch
        dx, da, h = fe.fused_mlp_bwd(x, g, w1, b1, w2, act)
        return (dx, torch.matmul(da.t(), x), torch.matmul(g.t(), h),
                da.sum(0, dtype=torch.float32))

    staged_ms = time_ms(staged, reps)
    lib_act = fe._ACTIVATIONS[act]
    leaves = [t.detach().requires_grad_() for t in (x, w1t, b1, w2t)]
    out = F.linear(lib_act(F.linear(leaves[0], leaves[1], leaves[2])), leaves[3])
    lib_ms = time_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), reps)
    del out, leaves
    es = x.element_size()
    nbytes = ((2 * x.numel() + g.numel() + w1.numel() + b1.numel() + w2.numel()) * es
              + 4 * (w1.numel() + w2.numel() + b1.numel()))
    flops = 2.0 * rows * dff * (3 * din + 2 * dout)  # z, g W2^T, dx, dW1, dW2
    bms, by = bound_ms(nbytes, flops, dtype)
    row.update(ms=kernel_ms, stage_ms=stages, plain_ms=plain_ms, library_ms=lib_ms,
               staged_ms=staged_ms, bound_ms=bms, bound_by=by)
    return row


ACC_STAGES = (("zdh", "fused_mlp_bwd_acc_zdh"), ("dx", "fused_mlp_bwd_acc_dx"),
              ("dw", "fused_mlp_bwd_acc_dw"), ("sum", "fused_mlp_bwd_acc_sum"))


def stage_ms(fn, stages, reps=5):
    """Device time a call of ``fn`` of each of a kernel's stages (``stages``:
    (stage, a text of its kernels' names)), from torch.profiler over
    ``reps`` calls; 'not measured' when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        for stage, kernel in stages:
            if kernel in e.key and us:
                out[stage] = out.get(stage, 0.0) + us / 1e3 / reps
    return out or "not measured"


def acc_threshold(fe, rows=(256, 512, 1024, 2048, 4096, 8192, 16384, 18464, 19712, 50432,
                            65536), din=768, dff=3072, dout=768):
    """#5 against the route it replaces (#4 plus the library's dW products
    and the db1 sum) at the row counts around ``fused_mlp_bwd_acc_supported``'s
    threshold, bf16, exact GELU: the numbers ``_ACC_MIN_ROWS`` is set from.
    Above 16,384 rows the paths' own counts: ALBEF's ViT-B/16 at 384 (18,464),
    CLIP's text tower (19,712), ViT-B/16's at batch 256 (50,432) and the LM's
    (65,536)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for r in rows:
        x, g, w1t, b1, w2t = _mlp_bwd_inputs(r, din, dff, dout, torch.bfloat16, gen)
        w1, w2 = w1t.t(), w2t.t()

        def staged():
            dx, da, h = fe.fused_mlp_bwd(x, g, w1, b1, w2, "gelu_exact")
            return (dx, torch.matmul(da.t(), x), torch.matmul(g.t(), h),
                    da.sum(0, dtype=torch.float32))

        acc = lambda: fe.fused_mlp_bwd_acc(x, g, w1, b1, w2, "gelu_exact")  # noqa: E731
        ms = [time_ms(f, 20) for f in (staged, acc, acc, staged)]  # in turns
        out[r] = {"staged_ms": (ms[0] + ms[3]) / 2, "acc_ms": (ms[1] + ms[2]) / 2}
    return out


# Kernel #5's shapes: every activation at 1,000 rows (a ragged last tile),
# then the train steps' MLPs: CLIP ViT-B/32 vision and text at batch 256,
# FLAVA's image, text and multimodal MLPs at batch 64, the LM at 8 x 8192,
# ALBEF's ViT-B/16 at 384 at batch 32 (18,464 rows).
ACC_CASES = [(f"ragged_1000_{act}", 1000, 768, 3072, 768, act, False)
             for act in ("quick_gelu", "gelu", "gelu_exact", "relu", "silu")] + [
    ("clip_vision", TRAIN_BATCH * 50, 768, 3072, 768, "quick_gelu", True),
    ("clip_text", TRAIN_BATCH * 77, 512, 2048, 512, "quick_gelu", True),
    ("flava_image", 64 * 197, 768, 3072, 768, "gelu_exact", True),
    ("flava_text", 64 * 77, 768, 3072, 768, "gelu_exact", True),
    ("flava_mm", 64 * 275, 768, 3072, 768, "gelu_exact", True),
    ("lm_train", 8 * 8192, 768, 3072, 768, "gelu_exact", True),
    ("albef_vit", 32 * 577, 768, 3072, 768, "gelu_exact", True),
]


def check_acc_kernel(fe, dtypes=(torch.bfloat16, torch.float32), timing=True):
    """Kernel #5 at ``ACC_CASES`` in each dtype; the train steps' shapes are
    timed in bf16, the dtype they run in."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for dtype in dtypes:
        for name, r, din, dff, dout, act, timed in ACC_CASES:
            row = mlp_bwd_acc_case(fe, name, r, din, dff, dout, act, dtype, gen,
                                   timing=timing and timed and dtype == torch.bfloat16)
            print("kernel_check " + json.dumps(row), flush=True)
            rows.append(row)
            torch.cuda.empty_cache()
    return rows


def _segments(b, s, gen):
    """(b, s) int32 packed-document ids: 4 documents a row, cut at random."""
    cuts = torch.sort(torch.randperm(s - 1, generator=gen, device="cuda")[:3] + 1).values
    ids = torch.searchsorted(cuts, torch.arange(s, device="cuda"), right=True)
    return ids.to(torch.int32)[None].expand(b, s).contiguous()


def _key_lengths(b, s, gen, lo):
    """(b,) seeded lengths of the real tokens of padded text rows in
    [lo, s], the first row full."""
    n = torch.randint(lo, s + 1, (b,), device="cuda", generator=gen)
    n[0] = s
    return n


MASK_BIASES = ("causal_mask", "coca_text", "qformer_itg", "key_padding", "masked_row")


def make_bias(kind, b, h, sq, sk, gen):
    """The additive float bias of a case, as the path hands it to #6:
    "1h1k" an ALiBi-style per-head key ramp; "b1qk" a dense random (B, 1,
    Sq, Sk); the masks, 0 where a pair attends: "causal_mask" CoCa's fusion
    self-attention's (1, 1, S, S) causal bool, "coca_text" its text
    decoder's (B, 1, S, S) causal AND key padding with the last (CLS) key
    always open, both as the dispatch turns a bool mask into a bias (-1e30
    elsewhere); "qformer_itg" the Q-Former's captioning pass, (B, 1, Sq, Sk)
    over Sk - Sq cached query rows all open, then causal text with key
    padding, as ``(1 - mask) * -10000``; "key_padding" a BERT-style (B, 1,
    1, Sk) key-padding bias, -1e30 past each row's length (the first row
    full); "masked_row" (B, 1, Sq, Sk) key padding with query row Sq / 2 of
    every batch row masked wholly (-1e30 at every key: the plain version
    averages that row's visible V)."""
    if kind is None:
        return None
    if kind in ("key_padding", "masked_row"):
        keys = torch.arange(sk, device="cuda")[None, :] < _key_lengths(b, sk, gen, 1)[:, None]
        bias = torch.where(keys, 0.0, -1e30)[:, None, None, :]
        if kind == "key_padding":
            return bias
        bias = bias.expand(b, 1, sq, sk).clone()
        bias[:, :, sq // 2] = -1e30
        return bias
    if kind == "1h1k":
        return -0.05 * torch.rand(1, h, 1, 1, device="cuda", generator=gen) * torch.arange(
            sk, device="cuda")[None, None, None, :]
    if kind == "b1qk":
        return torch.randn(b, 1, sq, sk, device="cuda", generator=gen)
    causal = torch.ones(sq, sq, dtype=torch.bool, device="cuda").tril()
    if kind == "causal_mask":
        return torch.where(causal, 0.0, -1e30)[None, None]
    if kind == "coca_text":
        keys = torch.arange(sk, device="cuda")[None, :] < _key_lengths(b, sk - 1, gen, 6)[:, None]
        keys[:, -1] = True
        return torch.where(causal[None] & keys[:, None, :], 0.0, -1e30)[:, None]
    if kind == "qformer_itg":
        prefix = sk - sq
        keys = (torch.arange(sq, device="cuda")[None, :]
                < _key_lengths(b, sq, gen, 4)[:, None]).float()
        m = torch.cat([torch.ones(sq, prefix, device="cuda"), causal.float()], dim=1)
        m = m[None] * torch.cat([torch.ones(b, prefix, device="cuda"), keys], dim=1)[:, None, :]
        return ((1.0 - m) * -10000.0)[:, None]
    raise ValueError(f"unknown bias kind {kind!r}")


def _visible_pairs(bias, causal, b, sq, sk, h, seg=(None, None)):
    """(query, key) pairs a case's function needs: the causal, segment or
    mask pattern's open pairs over every batch row and head."""
    visible = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
    if causal:
        visible = visible.tril(sk - sq)
    visible = visible[None, None].expand(b, 1, sq, sk)
    if seg[0] is not None:
        visible = visible & (seg[0][:, None, :, None] == seg[1][:, None, None, :])
    if bias is not None:
        visible = visible & (bias > -1e3).expand(b, 1, sq, sk)
    return int(visible.sum().item()) * h


def flash_case(fa, name, b, h, sq, sk, d, causal, dtype, gen, bias_kind=None,
               segments=False, lse=False, timing=True):
    """Kernel #6 against its plain version (a batch row at a time where the
    (Sq, Sk) fp32 matrices of all rows would not fit), and a second launch
    into an output and lse filled with NaN bitwise equal to the first; with
    ``timing``, its time beside its bound, the plain version and the library
    call, SDPA with the same visibility and bias as an explicit mask
    (``is_causal`` where it is the square causal mask, since SDPA's causal
    is top-left aligned)."""
    q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=gen).to(dtype)
               for s in (sq, sk, sk))
    bias = make_bias(bias_kind, b, h, sq, sk, gen)
    qseg = kvseg = None
    if segments == "key_padding":  # a (B, Sk) key mask as segment ids, queries all 1
        qseg = torch.ones(b, sq, dtype=torch.int32, device="cuda")
        kvseg = mdetr_key_mask(b, sk, gen).to(torch.int32)
    elif segments == "masked_tiles":  # key padding over whole key tiles, a row seeing no key
        qseg = torch.ones(b, sq, dtype=torch.int32, device="cuda")
        qseg[:, sq // 2] = 2
        kvseg = mdetr_key_mask(b, sk, gen).to(torch.int32)
        kvseg[:, MASKED_TILES] = 0
    elif segments:
        qseg = kvseg = _segments(b, sq, gen)
    kw = dict(causal=causal, return_lse=lse, q_segment_ids=qseg, kv_segment_ids=kvseg)
    rows = b if b * h * sq * sk <= 2 ** 30 else 1  # batch rows of one plain call
    exact = dtype == torch.float32  # fp32 is held against the plain version in float64

    def plain(i, dt=None):
        cut = (lambda x: x if x is None or x.shape[0] == 1 else x[i:i + rows])  # noqa: E731
        cast = (lambda x: x) if dt is None else (lambda x: x.to(dt))  # noqa: E731
        return fa.flash_attention_plain(
            cast(q[i:i + rows]), cast(k[i:i + rows]), cast(v[i:i + rows]), cut(bias),
            causal=causal, return_lse=lse, q_segment_ids=cut(qseg), kv_segment_ids=cut(kvseg))

    with torch.inference_mode():
        got = fa.flash_attention_forward(q, k, v, bias, **kw)
        out, got_lse = (got[0], got[1]) if lse else (got, None)
        again = fa._grad_like(q).fill_(math.nan)
        again_lse = None if got_lse is None else torch.full_like(got_lse, math.nan)
        fa._flash_fwd_launch(q, k, v, bias, again, again_lse, causal=causal, sm_scale=None,
                             q_segment_ids=qseg, kv_segment_ids=kvseg)
        torch.cuda.synchronize()
        deterministic = torch.equal(out, again) and (
            got_lse is None or torch.equal(got_lse, again_lse))
        del again, again_lse
        # the kernel's distance from the reference (the plain version in
        # the kernel's dtype; in fp32 the plain version run in float64), and
        # in fp32 the plain fp32 version's own distance from float64
        err = rel_err = plain_rel = 0.0
        lse_fin, lse_err, lse_scale, plain_lse_err = True, None, 1.0, 0.0
        for i in range(0, b, rows):
            ref = plain(i, torch.float64 if exact else None)
            ref_out = ref[0] if lse else ref
            err = max(err, (out[i:i + rows].double() - ref_out.double()).abs().max().item())
            rel_err = max(rel_err, row_relative_error(out[i:i + rows].double(), ref_out))
            if exact:
                own = plain(i)
                plain_rel = max(plain_rel, row_relative_error((own[0] if lse else own).double(),
                                                              ref_out))
            if lse:
                fin = torch.isfinite(ref[1])
                e = (got_lse[i:i + rows][fin].double() - ref[1][fin]).abs().max().item()
                lse_err = e if lse_err is None else max(lse_err, e)
                lse_scale = max(lse_scale, ref[1][fin].abs().max().item())
                lse_fin = lse_fin and bool(torch.equal(torch.isfinite(got_lse[i:i + rows]), fin))
                if exact:
                    plain_lse_err = max(plain_lse_err, (own[1][fin].double() - ref[1][fin])
                                        .abs().max().item())
            del ref, ref_out
        tol = ROW_RELATIVE_BAR["flash_attention", dtype]
        # fp32: the bar, or twice the plain fp32 version's own distance from
        # float64, whichever is larger (the same sums in another order)
        bar = max(tol, 2.0 * plain_rel)
        lse_bar = max(1e-4 * lse_scale, 2.0 * plain_lse_err)
        lse_ok = lse_fin and (lse_err is None or lse_err <= lse_bar)
        row = dict(kernel="flash_attention", case=name, shape=[b, h, sq, sk, d], causal=causal,
                   bias=bias_kind, segments=segments, lse=lse,
                   dtype=str(dtype).replace("torch.", ""), route=fwd_route(fa, dtype, d),
                   max_abs_err=err, rel_err=rel_err,
                   tol=tol, lse_err=lse_err, deterministic=deterministic,
                   ok=bool(rel_err <= bar and lse_ok and deterministic))
        if exact:
            row.update(reference="float64", plain_rel_err=plain_rel, bar=bar,
                       plain_lse_err=plain_lse_err if lse else None)
        if not timing:
            return row
        visible = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
        if causal:
            visible = visible.tril(sk - sq)
        visible = visible[None, None].expand(b, 1, sq, sk)
        if segments:
            visible = visible & (qseg[:, None, :, None] == kvseg[:, None, None, :])
        if bias_kind in MASK_BIASES:  # the work a mask leaves
            visible = visible & (bias > -1e3).expand(b, 1, sq, sk)
        pairs = int(visible.sum().item()) * h
        lib_mask = None
        if bias is not None or segments or (causal and sq != sk):
            lib_mask = torch.where(visible, 0.0, -math.inf)
            if bias is not None:
                lib_mask = lib_mask + bias
            lib_mask = lib_mask.to(dtype)
        del visible
        lib_causal = causal and lib_mask is None
        call = lambda: fa.flash_attention_forward(q, k, v, bias, **kw)  # noqa: E731
        kernel_ms = time_ms(call, 1)
        reps = reps_for(kernel_ms)
        kernel_ms = time_ms(call, reps)
        plain_ms = time_ms(lambda: [plain(i) for i in range(0, b, rows)],
                           max(1, reps // 4) if rows == b else 1, warmup=1)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=lib_mask, is_causal=lib_causal)
        lib_ms = time_ms(lib, reps)
        # the profiler's device time: at small shapes the events time the
        # wrappers' host work
        dev_ms = device_ms(call, None, calls=max(3, min(20, reps)))
        lib_dev_ms = device_ms(lib, None, calls=max(3, min(20, reps)))
        del lib_mask, lib
    es = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * es
    nbytes += 0 if bias is None else bias.numel() * 4
    nbytes += 0 if not segments else (b * sq + b * sk) * 4
    nbytes += 0 if not lse else b * h * sq * 4
    flops = 4.0 * d * pairs  # q.k and p.v over the visible (query, key) pairs
    bms, by = bound_ms(nbytes, flops, dtype)
    row.update(ms=kernel_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
               tflops=flops / kernel_ms / 1e9, device_ms=dev_ms, library_device_ms=lib_dev_ms)
    return row


def decode_mask(b, s, length, gen, lo=600, hi=3200):
    """(b, 1, s, L) bool: row i of slot n sees positions <= pos_n + i, pos_n
    drawn in [lo, hi) as the engine's slots sit after prompts of 600-3000
    tokens; the last row is an idle slot pinned at L - 1, as the engine
    pins it."""
    pos = torch.randint(lo, hi, (b,), device="cuda", generator=gen)
    pos[-1] = length - s
    ar = torch.arange(length, device="cuda")
    rows = pos[:, None] + torch.arange(s, device="cuda")[None, :]
    return ar[None, None, None, :] <= rows[:, None, :, None]


def _qca_inputs(qa, kv, b, hq, hkv, s, length, d, dtype, gen, lo, hi):
    q = torch.randn(b, hq, s, d, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, hkv, length, d, device="cuda", generator=gen)
    v = torch.randn(b, hkv, length, d, device="cuda", generator=gen)
    kc, vc = kv.QuantizedKV(*kv.quantize_kv(k)), kv.QuantizedKV(*kv.quantize_kv(v))
    return q, kc, vc, decode_mask(b, s, length, gen, lo, hi)


def qca_case(qa, kv, name, b, hq, hkv, s, length, d, dtype, gen, lo=600, hi=3200,
             blind=False, timing=True):
    """Kernel #10 against its plain version, each element to its row's scale,
    and a second launch through ``_launch`` into an output and a scratch
    filled with NaN, bitwise equal to the first (the counters zeroed by the
    scores kernel, every score, statistic and partial read written first,
    the runs summed in a fixed order); the library call is SDPA over a bf16
    cache of the same length (another function: it reads twice the cache
    bytes, all L positions). ``blind``: the first slot's first query row
    sees no position (p = 1 / L everywhere, as -1e30 scores give)."""
    q, kc, vc, mask = _qca_inputs(qa, kv, b, hq, hkv, s, length, d, dtype, gen, lo, hi)
    if blind:
        mask[0, :, 0] = False
    with torch.inference_mode():
        out = qa.quantized_cache_attention(q, kc, vc, mask)
        ref = qa.quantized_cache_attention_plain(q, kc, vc, mask)
        again = torch.full_like(out, float("nan"))
        ws = torch.full((qa._workspace_bytes(b, hkv, (hq // hkv) * s, length, d),),
                        255, dtype=torch.uint8, device="cuda")
        qa._launch(q, kc, vc, mask, again, ws)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        rel_err = row_relative_error(out, ref)
        tol = ROW_RELATIVE_BAR["quantized_cache_attention", dtype]
        deterministic = bool(torch.equal(out, again))
        row = dict(kernel="quantized_cache_attention", case=name,
                   shape=[b, hq, hkv, s, length, d], dtype=str(dtype).replace("torch.", ""),
                   max_abs_err=err, rel_err=rel_err, tol=tol,
                   deterministic=deterministic, ok=bool(rel_err <= tol and deterministic))
        if not timing:
            return row
        call = lambda: qa.quantized_cache_attention(q, kc, vc, mask)
        call_ms = time_ms(call, 1)
        reps = reps_for(call_ms)
        call_ms = time_ms(call, reps)  # the host's wrapper time, where it is longer
        kernel_ms = device_ms(call, "quantized_cache_attention")
        plain_ms = time_ms(lambda: qa.quantized_cache_attention_plain(q, kc, vc, mask),
                           max(3, reps // 4))
        group = hq // hkv
        kb = kc.dequantize(torch.bfloat16).repeat_interleave(group, dim=1)
        vb = vc.dequantize(torch.bfloat16).repeat_interleave(group, dim=1)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q.to(torch.bfloat16), kb, vb, attn_mask=mask), reps)
        # the positions some row of a slot sees: the rows the kernel reads
        seen = int(mask.any(dim=2).sum().item())  # sum over slots
    nbytes = seen * hkv * (2 * d + 8) + mask.numel() + (q.numel() + out.numel()) * q.element_size()
    flops = 4.0 * seen * hkv * group * s * d
    bms, by = bound_ms(nbytes, flops, torch.bfloat16)
    row.update(ms=kernel_ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
               library="SDPA over a bf16 cache (2x the bytes, all positions)", bound_ms=bms,
               bound_by=by)
    return row


# Kernel #10's cases: the LM decode tick (33 slots x 12 heads, 4096
# positions), a verify window, a GQA group, head width 128, a slot whose
# first query row sees nothing, and, in bf16 (the LM's decode dtype),
# caches the old whole-row block refused: 8 query rows over 8,192
# positions, one row over 32,768 (positions spread over the whole cache).
# Not in fp32: rows that see 1,000-8,000 positions reach p = 0.05, where
# one bf16 tie of p x v_scale, rounded to another side by any other order
# of the fp32 sums, moves an element by 2^-8 p |v|, past fp32's 2^-9
# (PERF.md: on the draw that failed, the plain version was 2.7e-3
# from a float64 softmax rounded as both round it, the kernel 6.0e-4).
QCA_CASES = [
    ("decode", 33, 12, 12, 1, 4096, 64, {}),
    ("verify_window", 8, 12, 12, 5, 4096, 64, {}),
    ("gqa_group4", 8, 12, 3, 2, 4096, 64, {}),
    ("head_width_128", 8, 8, 8, 1, 2048, 128, {}),
    ("rows_8_len_8192", 8, 12, 12, 8, 8192, 64, {"lo": 1000, "hi": 8000, "bf16_only": True}),
    ("len_32768", 4, 12, 12, 1, 32768, 64, {"lo": 4000, "hi": 32000, "bf16_only": True}),
    ("row_sees_nothing", 4, 4, 4, 2, 1024, 64, {"lo": 100, "hi": 800, "blind": True}),
]
CAPTION_QCA_CASES = [
    # the caption servers' ticks (their own generators): 32 slots and the
    # trash row over CoCa's 76 positions and BLIP-2's 32 query rows + 32
    # text positions
    ("coca_caption_76", 33, 12, 12, 1, 76, 64, {"lo": 1, "hi": 75}),
    ("blip2_caption_64", 33, 12, 12, 1, 64, 64, {"lo": 32, "hi": 63}),
]


def check_qca_kernel(qa, kv, dtypes=(torch.bfloat16, torch.float32), timing=True):
    """Kernel #10 at ``QCA_CASES`` in each dtype (the long caches in bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for dtype in dtypes:
        for cases, g in ((QCA_CASES, gen), (CAPTION_QCA_CASES, slice_gen(dtype))):
            for name, b, hq, hkv, s, length, d, kw in cases:
                kw = dict(kw)
                if kw.pop("bf16_only", False) and dtype != torch.bfloat16:
                    continue
                row = qca_case(qa, kv, name, b, hq, hkv, s, length, d, dtype, g, timing=timing,
                               **kw)
                print("kernel_check " + json.dumps(row), flush=True)
                rows.append(row)
                torch.cuda.empty_cache()
    return rows


def flash_threshold(fa, attn, gen, heads=12, d=64, batch=8):
    """Kernel #6 against the port's plain path at S = 32 to 1024, bf16
    causal at the LM's heads: the numbers FLASH_MIN_SEQ is set from."""
    rows = []
    with torch.inference_mode():
        for s in (32, 64, 128, 256, 512, 1024):
            q, k, v = (torch.randn(batch, heads, s, d, device="cuda", generator=gen)
                       .to(torch.bfloat16) for _ in range(3))
            flash = lambda: fa.flash_attention_forward(q, k, v, causal=True)
            plain = lambda: attn.attention_plain(q, k, v, is_causal=True)
            reps = reps_for(time_ms(flash, 1))
            rows.append({"seq": s, "flash_ms": time_ms(flash, reps),
                         "plain_ms": time_ms(plain, reps)})
    return rows


def cross_attention_reading(fa, attn, gen, b=32, h=12, sq=30, sk=577, d=64):
    """Kernel #6 against the port's plain path at ALBEF's cross-attention
    shape (30 text queries over 577 image tokens, non-causal, bf16), below
    ``FLASH_MIN_SEQ`` in the query length so the path takes the plain one:
    the forward alone and forward + backward (dq, dk, dv)."""
    q = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(b, h, sk, d, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(2))
    do = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(torch.bfloat16)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = {"shape": [b, h, sq, sk, d]}
    with torch.inference_mode():
        flash = lambda: fa.flash_attention_forward(q, k, v)  # noqa: E731
        plain = lambda: attn.attention_plain(q, k, v)  # noqa: E731
        reps = reps_for(time_ms(flash, 1))
        out.update(flash_fwd_ms=time_ms(flash, reps), plain_fwd_ms=time_ms(plain, reps))

    def both(fn):
        return lambda: torch.autograd.grad(fn(), (qg, kg, vg), do)

    out.update(flash_fwd_bwd_ms=time_ms(both(lambda: fa.flash_attention(qg, kg, vg)), reps),
               plain_fwd_bwd_ms=time_ms(both(lambda: attn.attention_plain(qg, kg, vg)[0]),
                                        reps))
    return out


# Kernel #6's cases: the LM prefill call, a train step's call (with and
# without packed documents), Sq != Sk, the masks, the 128-query tile's edges
# (Sq 127, 129, 191), the other routes (bias, head widths 32 and 128) and the
# CLIP ResNet towers' attention pools (non-causal, one key tile: RN50 and
# RN101 at the zero-shot batch, S = 50; RN50x4, x16 and x64 at 82, 145, 197).
FLASH_CASES = [
    ("prefill", 8, 12, 2048, 2048, 64, True, {}),
    ("train", 8, 12, 8192, 8192, 64, True, {"lse": True}),
    ("train_segment_ids", 8, 12, 8192, 8192, 64, True, {"lse": True, "segments": True}),
    ("sq512_sk2048", 8, 12, 512, 2048, 64, True, {}),
    ("non_causal", 4, 12, 1024, 1024, 64, False, {}),
    ("segment_ids", 4, 12, 1024, 1024, 64, True, {"segments": True}),
    ("bias_1h1k", 4, 12, 1024, 1024, 64, True, {"bias_kind": "1h1k"}),
    ("bias_b1qk", 4, 12, 1024, 1024, 64, False, {"bias_kind": "b1qk"}),
    ("lse", 4, 12, 1024, 1024, 64, True, {"lse": True}),
    ("ragged_1000", 4, 12, 1000, 1000, 64, True, {"lse": True}),
    ("sq127", 4, 12, 127, 127, 64, True, {"lse": True}),
    ("sq129_segment_ids", 4, 12, 129, 129, 64, True, {"lse": True, "segments": True}),
    ("sq191_sk300", 4, 12, 191, 300, 64, True, {"lse": True}),
    ("sq191_non_causal", 4, 12, 191, 191, 64, False, {}),
    ("head_width_32", 4, 12, 1024, 1024, 32, True, {}),
    ("head_width_128", 4, 12, 1024, 1024, 128, True, {}),
    ("attnpool_rn50", 256, 32, 50, 50, 64, False, {}),
    ("attnpool_rn50x4", 8, 40, 82, 82, 64, False, {}),
    ("attnpool_rn50x16", 8, 48, 145, 145, 64, False, {}),
    ("attnpool_rn50x64", 8, 64, 197, 197, 64, False, {}),
    # ALBEF: ViT-B/16 at 384 (577 = 4 x 128 + 65 tokens, non-causal) at the
    # train batch, at 256 (ALBEF's pre-training resolution: 257 tokens, the
    # last key tile holds one key), and its cross-attention's shape (30 text
    # queries over the 577 image tokens; the path takes the plain one there)
    ("albef_vit_577", 32, 12, 577, 577, 64, False, {"lse": True}),
    ("albef_vit_257", 2, 12, 257, 257, 64, False, {"lse": True}),
    ("albef_cross_30x577", 32, 12, 30, 577, 64, False, {}),
]
# The caption slice's cases, on generators of their own (``slice_gen``), so
# the cases above keep their inputs. CoCa ViT-L/14 at the train batch: the
# text decoder's causal-and-padding mask on the bias lane, the fusion
# layers' self-attention causal with no bias (the module's route: #6's
# causal loop), the fusion cross-attention (76 text queries
# over the 256 pooled image tokens) and the attention pooler (256 queries, 8
# heads of 96: the FP32-pipe route); BLIP-2 at the train batch: the frozen
# tower (257 tokens, 16 heads), the Q-Former's cross-attention (32 queries
# over the 257 image tokens) and its captioning pass (32 text queries over 32
# cached query rows and the text, the -10000 mask bias).
CAPTION_FLASH_CASES = [
    ("coca_text_77", 32, 12, 77, 77, 64, False, {"bias_kind": "coca_text", "lse": True}),
    ("coca_fusion_76", 32, 12, 76, 76, 64, True, {}),
    ("coca_cross_76x256", 32, 12, 76, 256, 64, False, {}),
    ("coca_pooler_d96", 32, 8, 256, 256, 96, False, {"lse": True}),
    ("blip2_vit_257", 128, 16, 257, 257, 64, False, {}),
    ("qformer_cross_32x257", 128, 12, 32, 257, 64, False, {}),
    ("blip2_itg_32x64", 128, 12, 32, 64, 64, False, {"bias_kind": "qformer_itg"}),
]
# The `wgmma` kernel's bias lane and head width 96, on generators of their
# own (``route_gen``): a BERT-style (B, 1, 1, Sk) key-padding bias, a query
# row the bias masks wholly, a ragged Sq = 77 (and Sk = 200) at D = 96 with
# lse, D = 96 causal over three key tiles, and D = 96 with a bias in blocks
# of two warpgroups (300 queries, a per-head ramp, lse) and of one (48
# queries, a row masked wholly).
ROUTE_FLASH_CASES = [
    ("key_padding_b11k", 32, 12, 77, 77, 64, False, {"bias_kind": "key_padding"}),
    ("bias_masked_row", 8, 12, 77, 300, 64, False, {"bias_kind": "masked_row", "lse": True}),
    ("d96_sq77_lse", 16, 8, 77, 200, 96, False, {"lse": True}),
    ("d96_causal", 4, 8, 300, 300, 96, True, {}),
    ("d96_bias_1h1k_300", 4, 8, 300, 300, 96, False, {"bias_kind": "1h1k", "lse": True}),
    ("d96_masked_row_48", 16, 8, 48, 300, 96, False, {"bias_kind": "masked_row"}),
]
# Head width 32 on the `wgmma` kernel, on generators of their own
# (``d32_gen``), untimed (MDETR's cases time the route), in blocks of one
# warpgroup (64 queries): one query, 64 and 65 over MDETR's 1,220 memory
# tokens (``MDETR_SEQ``) with its key padding; a ragged Sk (1,001: 105 keys
# in the last tile); causal with Sq != Sk; at batch 2 a key padding that
# masks two whole key tiles (keys 256-511, ``MASKED_TILES``) with a query
# row whose segment id no key carries (o = 0, lse = -inf); and 32 queries
# over two key tiles.
MASKED_TILES = slice(256, 512)
D32_FLASH_CASES = [
    ("d32_sq1", 8, 8, 1, 1220, 32, False, {"segments": "key_padding", "lse": True}),
    ("d32_sq64", 8, 8, 64, 1220, 32, False, {"segments": "key_padding"}),
    ("d32_sq65", 8, 8, 65, 1220, 32, False, {"lse": True}),
    ("d32_ragged_sk1001", 4, 8, 100, 1001, 32, False, {"lse": True}),
    ("d32_causal_300x700", 4, 8, 300, 700, 32, True, {"lse": True}),
    ("d32_masked_tiles", 2, 8, 100, 1220, 32, False, {"segments": "masked_tiles", "lse": True}),
    ("d32_sq32_sk200", 8, 8, 32, 200, 32, False, {"lse": True}),
]


def d32_gen(dtype: torch.dtype) -> torch.Generator:
    """The generator of ``D32_FLASH_CASES`` in ``dtype``, apart from the
    earlier cases' generators."""
    return torch.Generator(device="cuda").manual_seed(1800 if dtype == torch.bfloat16 else 1801)


# Generators of the fp32 cases' second and third runs: fp32 is held against
# float64 on three seeds' inputs.
FP32_SEEDS = (2, 3)


def check_flash_fwd_kernel(fa, dtypes=(torch.bfloat16, torch.float32), timing=True):
    """Kernel #6 at ``FLASH_CASES``, ``CAPTION_FLASH_CASES``,
    ``ROUTE_FLASH_CASES`` and ``D32_FLASH_CASES`` in each dtype (the train
    step's shapes in bf16 only, the dtype it runs in); every fp32 case again
    on the inputs of two more seeds (``FP32_SEEDS``, untimed)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for dtype in dtypes:
        runs = [("", gen, slice_gen(dtype), route_gen(dtype), d32_gen(dtype), timing)]
        if dtype == torch.float32:
            runs += [(f"_seed{n}",) + tuple(torch.Generator(device="cuda").manual_seed(
                1000 * n + i) for i in (0, 1, 2, 4)) + (False,) for n in FP32_SEEDS]
        for tag, g0, g1, g2, g3, timed in runs:
            for cases, g in ((FLASH_CASES, g0), (CAPTION_FLASH_CASES, g1),
                             (ROUTE_FLASH_CASES, g2), (D32_FLASH_CASES, g3)):
                for name, b, h, sq, sk, d, causal, kw in cases:
                    if name.startswith("train") and dtype != torch.bfloat16:
                        continue
                    row = flash_case(fa, name + tag, b, h, sq, sk, d, causal, dtype, g,
                                     timing=timed and cases is not D32_FLASH_CASES, **kw)
                    print("kernel_check " + json.dumps(row), flush=True)
                    rows.append(row)
                    torch.cuda.empty_cache()
    return rows


def check_new_kernels(fa, qa, kv):
    """The cases of kernels #6 and #10 (LM prefill, train and decode
    shapes)."""
    print("kernel_check tolerance #6, #10: row_relative_error (the largest |got - ref| / "
          "(|ref| + rms of ref's row)) within " + json.dumps(
              {f"{k}/{str(d).replace('torch.', '')}": v for (k, d), v in ROW_RELATIVE_BAR.items()}),
          flush=True)
    return check_flash_fwd_kernel(fa) + check_qca_kernel(qa, kv)


# Bars of row_relative_error for kernels #7-#9 (dq by query row, dk and dv by
# key row, the bias gradient ds by query row, each with its terms' scale),
# keyed on the output's dtype: dq, dk and dv come back in the inputs' dtype,
# ds in fp32 whatever the inputs (as the TPU kernel writes it). Set from the
# readings in PERF.md (its LM training findings).
ROW_RELATIVE_BAR_BWD = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -15}


def bwd_readings(got, ref, terms):
    """row_relative_error of each output with its terms, and, to show what
    the terms let through, without them: over every element, and over the
    elements that are no cancellation (|ref| at least 2^-8 of their terms)."""
    rel = {n: row_relative_error(got[n], ref[n], terms[n]) for n in got}
    no_terms = {n: [row_relative_error(got[n], ref[n]), row_relative_error(
        got[n], ref[n], keep=ref[n].float().abs() >= 2.0 ** -8 * terms[n])] for n in got}
    return rel, no_terms


def _bwd_inputs(b, h, sq, sk, d, dtype, gen, bias_kind, segments):
    """q, k, v as #6's cases make them; do in (B, Sq, H, D) storage, as the
    gradient of #6's output arrives; the (query, key) segment ids as #6's
    cases make them ("key_padding": queries 1, keys by MDETR's mask)."""
    q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=gen).to(dtype)
               for s in (sq, sk, sk))
    do = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dtype).transpose(1, 2)
    bias = make_bias(bias_kind, b, h, sq, sk, gen)
    seg = (None, None)
    if segments == "key_padding":
        seg = (torch.ones(b, sq, dtype=torch.int32, device="cuda"),
               mdetr_key_mask(b, sk, gen).to(torch.int32))
    elif segments:
        seg = (_segments(b, sq, gen),) * 2
    return q, k, v, do, bias, seg


def bwd_terms(fa, q, k, v, out, do, lse, dlse, bias, causal, seg, parts):
    """Each backward output element's sum over the absolute values of its
    terms, for ``row_relative_error``: with a_ij = p_ij (|do_i| . |v_j| +
    |do_i| . |o_i| + |dlse_i| log2(e)), the size of the terms of ds_ij = p_ij
    (do_i . v_j - delta_i), dq_i sums a_ij |k_j| scale, dk_j sums a_ij |q_i|
    scale, dv_j sums p_ij |do_i|, and ds_ij is a_ij. ``seg`` is the (query,
    key) segment ids."""
    d = q.shape[-1]
    scale = d ** -0.5
    s2 = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (scale * fa.LOG2E)
    if bias is not None:
        s2 = s2 + fa._as_4d_bias(bias) * fa.LOG2E
    visible = fa._visible(q.shape[2], k.shape[2], causal, *seg, q.device)
    lse = torch.where(lse == -math.inf, math.inf, lse)
    p = torch.where(visible, torch.exp2(s2 - lse[..., None]), 0.0)
    del s2
    row = (do.float().abs() * out.float().abs()).sum(-1)
    if dlse is not None:
        row = row + dlse.abs() * fa.LOG2E
    a = p * (torch.einsum("bhqd,bhkd->bhqk", do.float().abs(), v.float().abs()) + row[..., None])
    terms = {}
    if "dq" in parts:
        terms["dq"] = torch.einsum("bhqk,bhkd->bhqd", a, k.float().abs()) * scale
    if "dk" in parts:
        terms["dk"] = torch.einsum("bhqk,bhqd->bhkd", a, q.float().abs()) * scale
    if "dv" in parts:
        terms["dv"] = torch.einsum("bhqk,bhqd->bhkd", p, do.float().abs())
    if "ds" in parts:
        terms["ds"] = a
    return terms


def flash_bwd_case(fa, name, b, h, sq, sk, d, causal, dtype, gen, bias_kind=None,
                   segments=False, dbias=False, lse_cot=False, timing=False):
    """``flash_attention_bwd`` (#7 + #8 as one call; and #9 with ``dbias``)
    against the plain backward on the same inputs, each output element to
    its row's scale; with ``lse_cot`` through ``flash_attention_lse``'s
    autograd with both cotangents. Without it the call is launched again
    through ``_flash_bwd_launch`` into dq, dk, dv and a dq workspace filled
    with NaN first: dk and dv must come back bitwise equal to the first
    call's (no element left unwritten, no workspace read before its
    zero-fill), dq within its bar (its sum over key blocks has no fixed
    order on the one-pass route). The row's ``route`` is the C entry's
    (``bwd_route``). With ``timing`` (no bias gradient) the call is timed
    beside the plain backward, the SDPA backward (dq, dk and dv in one
    call, the bias and the segments as its mask) and the bound of
    :func:`flash_bwd_timing`."""
    q, k, v, do, bias, seg = _bwd_inputs(b, h, sq, sk, d, dtype, gen, bias_kind, segments)
    kw = dict(causal=causal, q_segment_ids=seg[0], kv_segment_ids=seg[1])
    relaunch = {}
    if lse_cot:
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out, lse = fa.flash_attention_lse(qg, kg, vg, causal)
        glse = torch.randn(lse.shape, device="cuda", generator=gen)
        gq, gk, gv = torch.autograd.grad((out, lse), (qg, kg, vg), (do, glse))
        got = {"dq": gq, "dk": gk, "dv": gv}
        with torch.no_grad():
            dlse = torch.where(torch.isfinite(lse), glse, 0.0)
            out, lse = out.detach(), lse.detach()
            ref = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_plain(
                q, k, v, out, lse, do, causal=causal, dlse=dlse)))
            if dtype == torch.float32:
                ref64 = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_plain(
                    q.double(), k.double(), v.double(), out.double(), lse, do.double(),
                    causal=causal, dlse=dlse)))
            terms = bwd_terms(fa, q, k, v, out, do, lse, dlse, None, causal, (None, None),
                              ("dq", "dk", "dv"))
    else:
        with torch.no_grad():
            out, lse = fa.flash_attention_forward(q, k, v, bias, return_lse=True, **kw)
            delta = fa._delta(out, do, None)
            got = dict(zip(("dq", "dk", "dv"),
                           fa.flash_attention_bwd(q, k, v, do, lse, delta, bias, **kw)))
            again = [fa._grad_like(t).fill_(math.nan) for t in (q, k, v)]
            ws = fa._dq_workspace(q)
            acc = None if ws is None else torch.full(ws, math.nan, device="cuda")
            fa._flash_bwd_launch(q, k, v, do, lse, delta, bias, *again, acc, sm_scale=None, **kw)
            relaunch["dq"] = again[0]
            relaunch["same"] = all(torch.equal(x, got[n]) for x, n in zip(again[1:], ("dk", "dv")))
            del again, acc
            parts = ("dq", "dk", "dv")
            if dbias:
                got["ds"] = fa.flash_attention_bwd_dbias(q, k, v, do, lse, delta, bias, **kw)
                parts += ("ds",)
                # again into a ds filled with NaN: no element left unwritten
                # (the ragged edges, the causal zero tiles), bitwise equal
                again = fa._dbias_out(q, sk).fill_(math.nan)
                fa._flash_bwd_dbias_launch(q, k, v, do, lse, delta, bias, again, sm_scale=None,
                                           **kw)
                relaunch["ds_same"] = torch.equal(again, got["ds"])
                del again
            ref = fa._bwd_plain_parts(q, k, v, do, lse, delta, bias, causal, None, *seg, parts)
            if dtype == torch.float32:
                ref64 = fa._bwd_plain_parts(q.double(), k.double(), v.double(), do.double(),
                                            lse, delta, bias, causal, None, *seg, parts)
            terms = bwd_terms(fa, q, k, v, out, do, lse, None, bias, causal, seg, parts)
    torch.cuda.synchronize()
    tol = {n: ROW_RELATIVE_BAR_BWD[got[n].dtype] for n in got}
    bar, extra = dict(tol), {}
    if dtype == torch.float32:
        # against the plain version run in float64, to the bar or to twice
        # the plain fp32 version's own distance from float64, whichever is
        # larger (the same sums in another order)
        plain_rel = {n: row_relative_error(ref[n], ref64[n], terms[n]) for n in got}
        bar = {n: max(tol[n], 2.0 * plain_rel[n]) for n in got}
        ref = ref64
        extra.update(reference="float64", plain_rel_err=plain_rel, bar=bar)
    rel, no_terms = bwd_readings(got, ref, terms)
    err = {n: (got[n].double() - ref[n].double()).abs().max().item() for n in got}
    ok = all(rel[n] <= bar[n] for n in rel)
    if relaunch:
        rel_dq = row_relative_error(relaunch["dq"], ref["dq"], terms["dq"])
        same = relaunch["same"] and relaunch.get("ds_same", True)
        extra.update(deterministic=same, relaunch_dq_rel_err=rel_dq)
        ok = ok and same and rel_dq <= bar["dq"]
    if dbias:
        extra.update(dbias_route=dbias_route(dtype, d))
    if timing:
        extra.update(bwd_case_timing(fa, q, k, v, do, causal, bias, seg))
    return dict(kernel="flash_attention_bwd", case=name, shape=[b, h, sq, sk, d], causal=causal,
                bias=bias_kind, segments=segments, dbias=dbias, lse_cotangent=lse_cot,
                dtype=str(dtype).replace("torch.", ""), route=bwd_route(fa, dtype, d),
                rel_err=rel, max_abs_err=err, tol=tol,
                rel_err_no_terms=no_terms, **extra, ok=ok)


def bwd_case_timing(fa, q, k, v, do, causal, bias=None, seg=(None, None)):
    """``flash_attention_bwd``'s ms at these inputs beside the plain
    backward's, the SDPA backward's (dq, dk and dv in one call; a bias goes
    in as its float mask, not differentiated, and the (query, key) segment
    ids ``seg`` as -inf where they differ) and the bound: five products over
    the visible pairs (a mask bias's and the segments' open ones), or q, k,
    v, do, lse, delta, the bias and the segment ids read once and dq, dk, dv
    written once."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    qseg, kvseg = seg
    kw = dict(causal=causal, q_segment_ids=qseg, kv_segment_ids=kvseg)
    with torch.no_grad():
        out, lse = fa.flash_attention_forward(q, k, v, bias, return_lse=True, **kw)
        delta = fa._delta(out, do, None)
        call = lambda: fa.flash_attention_bwd(q, k, v, do, lse, delta, bias, **kw)  # noqa: E731
        kernel_ms = time_ms(call, 1, warmup=1)
        kernel_ms = time_ms(call, reps_for(kernel_ms), warmup=1)
        plain_ms = time_ms(lambda: fa._bwd_plain_parts(q, k, v, do, lse, delta, bias, causal,
                                                        None, qseg, kvseg, ("dq", "dk", "dv")),
                           2, warmup=1)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    lib_mask = None if bias is None else bias.to(q.dtype)
    if qseg is not None:
        same = fa._visible(sq, sk, False, qseg, kvseg, q.device)
        seg_mask = torch.where(same, 0.0, -math.inf).to(q.dtype)
        lib_mask = seg_mask if lib_mask is None else lib_mask + seg_mask
    o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=lib_mask,
                                       is_causal=causal and sq == sk and lib_mask is None)
    lib = lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True)  # noqa: E731
    lib_ms = time_ms(lib, reps_for(kernel_ms))
    with torch.no_grad():
        dev_ms = device_ms(call, "flash_attention_bwd")
        names = kernel_names(call)
    lib_dev_ms = device_ms(lib, None)
    del o, out, lse, delta, lib_mask
    mask = bias if bias is not None and float(bias.min()) <= -1e3 else None
    pairs = _visible_pairs(mask, causal, b, sq, sk, h, seg)
    es = q.element_size()
    nbytes = (3 * q.numel() + 4 * k.numel()) * es + 2 * b * h * sq * 4
    nbytes += 0 if bias is None else bias.numel() * 4
    nbytes += 0 if qseg is None else (qseg.numel() + kvseg.numel()) * 4
    bms, by = bound_ms(nbytes, 10.0 * d * pairs, q.dtype)
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                device_ms=dev_ms, library_device_ms=lib_dev_ms, kernels=names,
                tflops=10.0 * d * pairs / kernel_ms / 1e9,
                library="SDPA backward (dq, dk and dv in one call)")


# The backward's cases (#7 + #8 as one call, #9): the LM prefill shape
# causal and #6's variants (head widths 32, 96 and 128 take the other
# routes), ALBEF's ViT-B/16 at 384 (the last 64-query stage holds one row)
# and at 256 (the last key tile holds one key), non-causal, timed in bf16;
# on one generator (seed 7) in this order.
BWD_CASES = [
    ("prefill", 8, 12, 2048, 2048, 64, True, {}),
    ("sq512_sk2048", 8, 12, 512, 2048, 64, True, {}),
    ("non_causal", 4, 12, 1024, 1024, 64, False, {}),
    ("segment_ids", 4, 12, 1024, 1024, 64, True, {"segments": True}),
    ("bias_1h1k_dbias", 4, 12, 1024, 1024, 64, True, {"bias_kind": "1h1k", "dbias": True}),
    ("bias_b1qk_dbias", 4, 12, 1024, 1024, 64, False, {"bias_kind": "b1qk", "dbias": True}),
    ("ragged_1000", 4, 12, 1000, 1000, 64, True, {"dbias": True}),
    ("head_width_32", 4, 12, 1024, 1024, 32, True, {}),
    ("head_width_128", 4, 12, 1024, 1024, 128, True, {}),
    ("head_width_96", 2, 4, 300, 300, 96, True, {"bias_kind": "1h1k", "dbias": True}),
    ("lse_cotangent", 4, 12, 1000, 1000, 64, True, {"lse_cot": True}),
    ("albef_vit_577", 32, 12, 577, 577, 64, False, {"timing": True}),
    ("albef_vit_257", 2, 12, 257, 257, 64, False, {"timing": True}),
]
# CoCa's and BLIP-2's trained attention: the mask biases (not
# differentiated: no #9), the fusion layers' self-attention causal with no
# bias (the module's route), the pooler at head width 96, the
# cross-attentions; on the caption slice's generator (``slice_gen``), timed
# in bf16.
CAPTION_BWD_CASES = [
    (name, b, h, sq, sk, d, causal, {"bias_kind": kind, "timing": True})
    for name, b, h, sq, sk, d, causal, kind in (
        ("coca_text_77", 32, 12, 77, 77, 64, False, "coca_text"),
        ("coca_fusion_76", 32, 12, 76, 76, 64, True, None),
        ("coca_cross_76x256", 32, 12, 76, 256, 64, False, None),
        ("coca_pooler_d96", 32, 8, 256, 256, 96, False, None),
        ("qformer_cross_32x257", 128, 12, 32, 257, 64, False, None),
        ("blip2_itg_32x64", 128, 12, 32, 64, 64, False, "qformer_itg"))]


# #9's `wgmma` kernel, on a generator of its own (``dbias_gen``): causal
# with ragged Sq and Sk (301: rows of ds 304 floats apart, the last key tile
# 45 keys, zero tiles above the diagonal), Sq != Sk non-causal with a dense
# (B, 1, Sq, Sk) bias, segment ids, and head widths 32 and 96 ragged.
DBIAS_BWD_CASES = [
    ("dbias_ragged_300x301", 2, 4, 300, 301, 64, True, {"bias_kind": "1h1k", "dbias": True}),
    ("dbias_sq130_sk301", 2, 4, 130, 301, 64, False, {"bias_kind": "b1qk", "dbias": True}),
    ("dbias_segment_ids", 2, 4, 200, 200, 64, True,
     {"bias_kind": "1h1k", "segments": True, "dbias": True}),
    ("dbias_d32_ragged", 2, 4, 300, 301, 32, True, {"bias_kind": "b1qk", "dbias": True}),
    ("dbias_d96_ragged", 2, 4, 130, 301, 96, True, {"bias_kind": "1h1k", "dbias": True}),
]


def dbias_gen(dtype: torch.dtype) -> torch.Generator:
    """The generator of ``DBIAS_BWD_CASES`` in ``dtype``."""
    return torch.Generator(device="cuda").manual_seed(1900 if dtype == torch.bfloat16 else 1901)


# The one-pass kernel at head width 96, on a generator of its own
# (``d96_gen``): the lse cotangent through ``flash_attention_lse`` over a
# ragged last query tile and key block, and causal with Sq < Sk (blocks
# whose first query tile starts past 0, the diagonal bottom-right aligned).
D96_BWD_CASES = [
    ("lse_cotangent_d96", 2, 4, 300, 300, 96, True, {"lse_cot": True}),
    ("sq100_sk300_d96", 2, 4, 100, 300, 96, True, {}),
]


def d96_gen(dtype: torch.dtype) -> torch.Generator:
    """The generator of ``D96_BWD_CASES`` in ``dtype``, apart from the
    earlier cases' generators."""
    return torch.Generator(device="cuda").manual_seed(1600 if dtype == torch.bfloat16 else 1601)


def check_bwd_kernels(fa, dtypes=(torch.bfloat16, torch.float32)):
    """The backward at ``BWD_CASES``, ``CAPTION_BWD_CASES``,
    ``D96_BWD_CASES`` and ``DBIAS_BWD_CASES`` in each dtype; every fp32 case
    again on the inputs of two more seeds (``FP32_SEEDS``, untimed)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = []
    for dtype in dtypes:
        runs = [("", gen, slice_gen(dtype), d96_gen(dtype), dbias_gen(dtype),
                 dtype == torch.bfloat16)]
        if dtype == torch.float32:
            runs += [(f"_seed{n}",) + tuple(torch.Generator(device="cuda").manual_seed(
                1000 * n + 7 + i) for i in range(4)) + (False,) for n in FP32_SEEDS]
        for tag, g0, g1, g2, g3, timed in runs:
            for case_list, g in ((BWD_CASES, g0), (CAPTION_BWD_CASES, g1), (D96_BWD_CASES, g2),
                                 (DBIAS_BWD_CASES, g3)):
                for name, b, h, sq, sk, d, causal, kw in case_list:
                    kw = dict(kw)
                    kw["timing"] = kw.pop("timing", False) and timed
                    cases.append(flash_bwd_case(fa, name + tag, b, h, sq, sk, d, causal,
                                                dtype, g, **kw))
                    torch.cuda.empty_cache()
    print("kernel_check tolerance #7-#9: row_relative_error with the terms, by the output's "
          "dtype (ds is fp32 in every case), within " + json.dumps(
              {str(k).replace("torch.", ""): v for k, v in ROW_RELATIVE_BAR_BWD.items()}),
          flush=True)
    for c in cases:
        print("kernel_check " + json.dumps(c), flush=True)
    return cases


def fusion_route_reading(fa, gen, b=32, h=12, s=76, d=64):
    """CoCa's fusion self-attention (32, 12, 76, 76, 64) bf16, forward and
    backward as its training step runs them, both ways the module can hand
    it to the kernels: the (1, 1, 76, 76) causal bool as a bias (#6's bias
    lane, the backward's masks from the bias) and ``causal`` with no bias
    (#6's unmasked causal loop, the one-pass backward's causal walk); SDPA
    (``is_causal``) beside them. Device ms of a forward and backward from
    the profiler (every kernel of the call: the calls are host-bound on the
    events) and the events' ms; the two ways' outputs and gradients against
    each other, which must agree to the backward's bar (``ok``). The
    numbers the module's route was chosen from; ``--ab`` reads them on both
    trees."""
    q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=gen).to(torch.bfloat16)
               .requires_grad_() for _ in range(3))
    do = torch.randn(b, h, s, d, device="cuda", generator=gen).to(torch.bfloat16)
    mask = make_bias("causal_mask", b, h, s, s, gen)
    ways = {"mask_bias": lambda: fa.flash_attention(q, k, v, mask, False),
            "causal": lambda: fa.flash_attention(q, k, v, None, True),
            "sdpa": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)}
    out, got = {}, {}
    for name, fwd in ways.items():
        step = lambda: (fwd(), *torch.autograd.grad(fwd(), (q, k, v), do))  # noqa: E731
        fwd_bwd = lambda: torch.autograd.grad(fwd(), (q, k, v), do)  # noqa: E731
        out[f"{name}_device_ms"] = device_ms(fwd_bwd, None)
        out[f"{name}_ms"] = time_ms(fwd_bwd, 50)
        got[name] = [x.detach() for x in step()]
    out["causal_vs_mask_rel_err"] = max(row_relative_error(x, y)
                                        for x, y in zip(got["causal"], got["mask_bias"]))
    out["ok"] = out["causal_vs_mask_rel_err"] <= ROW_RELATIVE_BAR_BWD[torch.bfloat16]
    return out


def flash_bwd_timing(fa, b=8, h=12, s=8192, d=64):
    """``flash_attention_bwd`` (#7 + #8 as one call: zero-fill, the one-pass
    kernel and dq's conversion) and #9 at the LM training shape, bf16 causal
    (#9 with an ALiBi-style (1, H, 1, S) bias, the case that differentiates
    one): each held against the plain backward (run a batch row at a time:
    its (S, S) fp32 matrices of all 8 rows would not fit) and timed beside
    the plain version, the SDPA backward (dq, dk and dv in one call, timed
    only) and the card's bound. The bound of the call counts the five
    products that the function needs (s, dp, dv, dk, dq: 10 d FLOPs a
    visible pair), and bytes as q, k, v, do, lse and delta read once and dq,
    dk, dv written once. The library time of #9 is the SDPA backward with a
    differentiable float mask (ALiBi plus the causal -inf), on the
    memory-efficient backend: it returns the mask's gradient, the full
    (B, H, S, S) ds summed to the mask's shape, with dq, dk and dv."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    dtype = torch.bfloat16
    q, k, v, do, _, _ = _bwd_inputs(b, h, s, s, d, dtype, gen, None, False)
    alibi = -0.05 * torch.rand(1, h, 1, 1, device="cuda", generator=gen) * torch.arange(
        s, device="cuda")[None, None, None, :]
    pairs = b * h * s * (s + 1) // 2
    es = q.element_size()
    io = 4 * q.numel() * es + 2 * b * h * s * 4  # q, k, v, do, lse, delta
    rows = []
    with torch.no_grad():
        for name, bias in (("flash_attention_bwd", None), ("flash_attention_bwd_dbias", alibi)):
            out, lse = fa.flash_attention_forward(q, k, v, bias, causal=True, return_lse=True)
            delta = fa._delta(out, do, None)
            args = (q, k, v, do, lse, delta, bias)
            fn = getattr(fa, name)
            parts = ("dq", "dk", "dv") if name == "flash_attention_bwd" else ("ds",)
            got = fn(*args, causal=True)
            got = dict(zip(parts, got if len(parts) > 1 else (got,)))
            tol = {n: ROW_RELATIVE_BAR_BWD[got[n].dtype] for n in parts}
            rel, err = {n: 0.0 for n in parts}, {n: 0.0 for n in parts}
            no_terms = {n: [0.0, 0.0] for n in parts}

            def plain(i):
                return fa._bwd_plain_parts(q[i:i + 1], k[i:i + 1], v[i:i + 1], do[i:i + 1],
                                           lse[i:i + 1], delta[i:i + 1], bias, True, None,
                                           None, None, parts)

            for i in range(b):
                ref = plain(i)
                terms = bwd_terms(fa, q[i:i + 1], k[i:i + 1], v[i:i + 1], out[i:i + 1],
                                  do[i:i + 1], lse[i:i + 1], None, bias, True, (None, None),
                                  parts)
                rel_i, no_terms_i = bwd_readings({n: got[n][i:i + 1] for n in parts}, ref, terms)
                for n in parts:
                    rel[n] = max(rel[n], rel_i[n])
                    no_terms[n] = [max(a, b) for a, b in zip(no_terms[n], no_terms_i[n])]
                    err[n] = max(err[n], (got[n][i:i + 1].float() - ref[n].float()).abs()
                                 .max().item())
                del ref, terms
            del got
            kernel_ms = time_ms(lambda: fn(*args, causal=True), 1, warmup=1)
            kernel_ms = time_ms(lambda: fn(*args, causal=True), reps_for(kernel_ms), warmup=1)
            plain_ms = time_ms(lambda: [plain(i) for i in range(b)], 2, warmup=1)
            if name == "flash_attention_bwd":
                flops, nbytes = 10.0 * d * pairs, io + 3 * q.numel() * es
            else:
                flops, nbytes = 4.0 * d * pairs, io + alibi.numel() * 4 + b * h * s * s * 4
            bms, by = bound_ms(nbytes, flops, dtype)
            rows.append(dict(kernel=name, case="train", shape=[b, h, s, s, d], causal=True,
                             dtype="bfloat16", rel_err=rel, max_abs_err=max(err.values()),
                             max_abs_err_by_part=err, tol=tol, rel_err_no_terms=no_terms,
                             ok=all(rel[n] <= tol[n] for n in rel), ms=kernel_ms,
                             plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                             tflops=flops / kernel_ms / 1e9))
            del out, lse, delta, args
            torch.cuda.empty_cache()
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_ms = time_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True), 3)
    del o
    from torch.nn.attention import SDPBackend, sdpa_kernel

    mask = (alibi + torch.full((s, s), -math.inf, device="cuda").triu(1)).to(dtype)
    mask.requires_grad_()
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask.expand(b, h, s, s))
        lib_ds_ms = time_ms(lambda: torch.autograd.grad(o, (mask, qg, kg, vg), do,
                                                        retain_graph=True), 3)
    del o, mask
    torch.cuda.empty_cache()
    for r in rows:
        dbias = r["kernel"].endswith("dbias")
        r["library_ms"] = lib_ds_ms if dbias else lib_ms
        r["library"] = ("SDPA backward with a differentiable float mask, memory-efficient "
                        "backend (ds summed to the mask's shape, dq, dk and dv in one call)"
                        if dbias else "SDPA backward (dq, dk and dv in one call)")
        print("kernel_check " + json.dumps(r), flush=True)
    return rows


def check_kernels(fe):
    return (check_attention_fwd_kernel(fe) + check_attention_bwd_kernel(fe)
            + check_mlp_bwd_kernel(fe))


# Faults planted in copies of the kernels' sources (under build/, never in
# the checkout's sources): (source, the kernel function's signature, text,
# replacement).
PLANTED_FAULTS = {
    "attention bwd: the ragged last key tile unmasked (padded keys' bias 0)": (
        "fused_qkv_attention_bwd.cu", "qkv_attention_bwd_wgmma_kernel(const __grid_constant__",
        ": 0.f) : -INFINITY;", ": 0.f) : 0.f;"),
    "attention bwd: the causal fill in natural units beside a log2 key bias": (
        "fused_qkv_attention_bwd.cu", "qkv_attention_bwd_wgmma_kernel(const __grid_constant__",
        "sacc[4 * n + e] = kMasked2;", "sacc[4 * n + e] = -1e30f;"),
    "attention bwd: padded keys take the causal fill (wgmma's pass 1)": (
        "fused_qkv_attention_bwd.cu", "qkv_attention_bwd_wgmma_kernel(const __grid_constant__",
        "if (key > q0 + 16 * ww + gq + 8 * (e >> 1) && key < S)",
        "if (key > q0 + 16 * ww + gq + 8 * (e >> 1))"),
    "attention bwd: p = 0 above the diagonal in wgmma's pass 2": (
        "fused_qkv_attention_bwd.cu", "void probs_t(float (&sacc)[KT / 2]",
        "s2 = kMasked2;", "s2 = -INFINITY;"),
    "attention bwd: padded keys take the causal fill (mma.sync)": (
        "fused_qkv_attention_bwd.cu", "qkv_attention_bwd_mma_kernel(const __nv_bfloat16*",
        "if (causal && key > row && (!MASKED || key < S)) s = -1e30f;",
        "if (causal && key > row) s = -1e30f;"),
    "attention bwd: mma.sync's query tiles skip the keys past them": (
        "fused_qkv_attention_bwd.cu", "qkv_attention_bwd_mma_kernel(const __nv_bfloat16*",
        "const int kg_end = causal && (!MASKED || m0 >= nm) ? min(KG, warp + 1) : KG;",
        "const int kg_end = causal ? min(KG, warp + 1) : KG;"),
    "attention bwd: mma.sync's key tiles skip the queries before them": (
        "fused_qkv_attention_bwd.cu", "qkv_attention_bwd_mma_kernel(const __nv_bfloat16*",
        "for (int it = causal && (!MASKED || nm == 0) ? warp : 0; it < KG; ++it)",
        "for (int it = causal ? warp : 0; it < KG; ++it)"),
    "attention bwd: the FP32 pipes' query rows skip the keys past the diagonal": (
        "fused_qkv_attention_bwd.cu", "qkv_attention_bwd_kernel(const T* __restrict__ qkv",
        "const int jend = causal && i >= nm ? i + 1 : S;", "const int jend = causal ? i + 1 : S;"),
    "attention bwd: the FP32 pipes' keys skip the queries before them": (
        "fused_qkv_attention_bwd.cu", "qkv_attention_bwd_kernel(const T* __restrict__ qkv",
        "const int istart = causal && nm == 0 ? j : 0;", "const int istart = causal ? j : 0;"),
    "quantized attention: the merge drops the last run": (
        "quantized_cache_attention.cu", "quantized_cache_attention_values_kernel(QArgs a)",
        "for (int k = 0; k < a.runs; ++k) o +=", "for (int k = 0; k < a.runs - 1; ++k) o +="),
    "bwd mma: dk and dv's in-bounds tiles skip the segment ids": (
        "flash_attention_bwd.cu", "flash_bwd_dkv_mma_kernel(Args a)",
        "const bool whole = !a.bias && !a.qseg && q0 + QT <= a.Sq",
        "const bool whole = !a.bias && q0 + QT <= a.Sq"),
    "bwd: one key past the causal diagonal": (
        "flash_attention_bwd.cu", "flash_bwd_wgmma_kernel(const __grid_constant__",
        "visible(a, b, i, j)",
        "(visible(a, b, i, j) || (a.causal && j == i + 1 + off && (!a.qseg || "
        "a.qseg[b * a.qseg_b + i] == a.kvseg[b * a.kvseg_b + j])))"),
    # (at least one tile a block: a block with none, as below 64 queries (the
    # Q-Former's 32) or a causal key block whose first query tile is the
    # ragged last one (D = 96's 300 x 300), would wait forever for its loads)
    "bwd: the ragged last query tile dropped": (
        "flash_attention_bwd.cu", "flash_bwd_wgmma_kernel(const __grid_constant__",
        "const int nq = (a.Sq + kWgTile - 1) / kWgTile;",
        "const int nq = max(first_query_tile(a, k0, kWgTile) + 1, a.Sq / kWgTile);"),
    "bwd: delta left out of ds": (
        "flash_attention_bwd.cu", "flash_bwd_wgmma_kernel(const __grid_constant__",
        "pe * (dpt[4 * n + e] - ((e & 1) ? d2.y : d2.x))", "pe * dpt[4 * n + e]"),
    "bwd: key block 0's dq part not added": (
        "flash_attention_bwd.cu", "void add_dq_part(const float (&dq)[16]",
        "if (issuer) wg::tma_reduce_add_3d(",
        "if (issuer && blockIdx.x != 0) wg::tma_reduce_add_3d("),
    "bwd: the dq workspace not zero-filled": (
        "flash_attention_bwd.cu", "cudaError_t launch_wgmma(",
        "cudaMemsetAsync(ws, 0, bytes, st)", "cudaSuccess"),
    "bwd: D = 96's last 32-column dq box not reduced": (
        "flash_attention_bwd.cu", "void add_dq_part_96(const float (&dq)[32]",
        "wg::tma_reduce_add_3d_part(map, boxes + 4 * wgi * kBox, 64 * wgi, q0, bh);",
        "if (wgi == 0) wg::tma_reduce_add_3d_part(map, boxes + 4 * wgi * kBox, 64 * wgi, q0, "
        "bh);"),
    "bwd: D = 96's last 32 columns of dk not written": (
        "flash_attention_bwd.cu", "flash_bwd_wgmma_kernel(const __grid_constant__",
        "*reinterpret_cast<__nv_bfloat162*>(dkg + key * a.o0s[2] + c) =",
        "if (c < 64) *reinterpret_cast<__nv_bfloat162*>(dkg + key * a.o0s[2] + c) ="),
    "acc: the first row run's dW partial left out of the sum": (
        "fused_mlp_bwd_acc.cu", "fused_mlp_bwd_acc_sum_kernel(const float*",
        "for (int c = 0; c < splits; ++c)", "for (int c = 1; c < splits; ++c)"),
    "acc: the last 16 rows of every k-block left out of dW": (
        "fused_mlp_bwd_acc.cu", "fused_mlp_bwd_acc_dw_kernel(const __grid_constant__",
        "for (int kk = 0; kk < BK / 16; ++kk) wg::mma_step<wg::MN, wg::MN>",
        "for (int kk = 0; kk < BK / 16 - 1; ++kk) wg::mma_step<wg::MN, wg::MN>"),
    "acc: act' left out of da": (
        "mlp_bwd_common.cuh", "void zdh_stage(const ZdhParams& p",
        "const float da0 = dh[4 * j + 2 * hf] * d0;", "const float da0 = dh[4 * j + 2 * hf];"),
    "mlp_bwd: act' left out of da's odd columns": (
        "mlp_bwd_common.cuh", "void zdh_stage(const ZdhParams& p",
        "const float da1 = dh[4 * j + 2 * hf + 1] * d1;",
        "const float da1 = dh[4 * j + 2 * hf + 1];"),
    "mlp_bwd: the first Dff run left out of dx's sum": (
        "fused_mlp_bwd.cu", "fused_mlp_bwd_dx_sum_kernel(const float4*",
        "for (int r = 0; r < splits; ++r)", "for (int r = 1; r < splits; ++r)"),
    "fwd: one key past the causal diagonal": (
        "flash_attention_fwd.cu", "void mask_tile(float (&s)[64]",
        "a.causal ? min(a.Sk - 1, r0 + a.Sk - a.Sq) : a.Sk - 1,\n"
        "                       a.causal ? min(a.Sk - 1, r0 + 8 + a.Sk - a.Sq) : a.Sk - 1};",
        "a.causal ? min(a.Sk - 1, r0 + 1 + a.Sk - a.Sq) : a.Sk - 1,\n"
        "                       a.causal ? min(a.Sk - 1, r0 + 9 + a.Sk - a.Sq) : a.Sk - 1};"),
    "fwd: the ragged last query tile not stored": (
        "flash_attention_fwd.cu", "flash_fwd_wgmma_kernel(const __grid_constant__",
        "if (i >= a.Sq) continue;", "if (i >= a.Sq / kWgRows * kWgRows) continue;"),
    "fwd: alpha left out of the O rescale": (
        "flash_attention_fwd.cu", "void flash_tile(const WgParams& p",
        "for (int x = 0; x < D / 2; ++x) o[x] *= alpha[(x >> 1) & 1];",
        "for (int x = 0; x < D / 2; ++x) o[x] *= 1.f;"),
    "fwd: the bias's head stride ignored": (
        "flash_attention_fwd.cu", "void bias_tile(float (&bv)[64]",
        "b * a.bs[0] + h * a.bs[1]", "b * a.bs[0] + 0 * a.bs[1]"),
    "fwd: a segment id off by one key at D = 32": (
        "flash_attention_fwd.cu", "void mask_tile_ids(float (&s)[64]",
        "const int id = c ? kid.y : kid.x;", "const int id = c ? kid.x : kid.y;"),
    "dbias: the ragged last key tile not stored": (
        "flash_attention_bwd.cu", "void dbias_tile(const DbParams& p",
        "  if (issuer) {\n    wg::tma_store_3d(",
        "  if (issuer && k0 + kDbKeys <= a.Sk) {\n    wg::tma_store_3d("),
    "dbias: a causal zero tile not written": (
        "flash_attention_bwd.cu", "flash_bwd_dbias_kernel(const __grid_constant__",
        "for (int t = n; t < nk; ++t) {", "for (int t = n + 1; t < nk; ++t) {"),
    "fwd: the last 32 columns of D = 96 unwritten": (
        "flash_attention_fwd.cu", "flash_fwd_wgmma_kernel(const __grid_constant__",
        "for (int jc = 0; jc < D / 8; ++jc)", "for (int jc = 0; jc < (D == 96 ? 8 : D / 8); ++jc)"),
    "attention: the ragged last query tile dropped": (
        "fused_qkv_attention.cu", "void attend(const WgParams& p",
        "if (row >= S) continue;", "if (row >= S / 64 * 64) continue;"),
    "attention: a causal tile with a wholly masked row skips the chunks past it": (
        "fused_qkv_attention.cu", "qkv_attention_wgmma_kernel(const __grid_constant__",
        "const int nc = p.causal && (open || !p.key_bias) ? min(NC, t + 1) : NC;",
        "const int nc = p.causal ? min(NC, t + 1) : NC;"),
    "attention: the key bias left out": (
        "fused_qkv_attention.cu", "qkv_attention_wgmma_kernel(const __grid_constant__",
        "p.key_bias ? p.key_bias[(size_t)b * S + j] * kLog2e : 0.f", "0.f"),
    "mlp: b1 left out of stage H's epilogue": (
        "fused_mlp.cu", "gemm_tiles(const GemmParams& p)",
        "const float bias0 = to_f(p.bias[c]), bias1 = to_f(p.bias[c + 1]);",
        "const float bias0 = ACT < 0 ? to_f(p.bias[c]) : 0.f, "
        "bias1 = ACT < 0 ? to_f(p.bias[c + 1]) : 0.f;"),
    "mlp: stage H's last ragged row tile of h not stored": (
        "fused_mlp.cu", "gemm_tiles(const GemmParams& p)", "if (r < p.R)",
        "if (r < (ACT >= 0 ? p.R / BM * BM : p.R))"),
    "mlp: stage O's last ragged row tile of the output not stored": (
        "fused_mlp.cu", "gemm_tiles(const GemmParams& p)", "if (r < p.R)",
        "if (r < (ACT < 0 ? p.R / BM * BM : p.R))"),
}
# For each patched source: the sources its copy builds (its wrappers bind
# their symbols) and the bf16 checks that run against it. The MLP backward's
# shared stages (mlp_bwd_common.cuh) run under both #4's checks and #5's.
_MLP_SOURCES = ("fused_qkv_attention.cu", "fused_qkv_attention_bwd.cu", "fused_mlp.cu",
                "fused_mlp_bwd.cu", "fused_mlp_bwd_acc.cu")
PLANTED_FAULT_CHECKS = {
    "fused_qkv_attention.cu": (
        _MLP_SOURCES,
        "from multimodal_tpu_torch.ops import fused_encoder as fe; "
        "cs.check_attention_fwd_kernel(fe, (torch.bfloat16,), timing=False)"),
    "fused_qkv_attention_bwd.cu": (
        _MLP_SOURCES,
        "from multimodal_tpu_torch.ops import fused_encoder as fe; "
        "cs.check_attention_bwd_kernel(fe, (torch.bfloat16,), timing=False)"),
    "quantized_cache_attention.cu": (
        ("quantized_cache_attention.cu",),
        "from multimodal_tpu_torch.ops import kv_cache as kv, quantized_attention as qa; "
        "cs.check_qca_kernel(qa, kv, (torch.bfloat16,), timing=False)"),
    "flash_attention_fwd.cu": (
        ("flash_attention_fwd.cu", "flash_attention_bwd.cu"),
        "from multimodal_tpu_torch.ops import flash_attention as fa; "
        "cs.check_flash_fwd_kernel(fa, (torch.bfloat16,), timing=False)"),
    "fused_mlp_bwd.cu": (
        _MLP_SOURCES,
        "from multimodal_tpu_torch.ops import fused_encoder as fe; "
        "cs.check_mlp_bwd_kernel(fe, (torch.bfloat16,), timing=False)"),
    "mlp_bwd_common.cuh": (
        _MLP_SOURCES,
        "from multimodal_tpu_torch.ops import fused_encoder as fe; "
        "cs.check_mlp_bwd_kernel(fe, (torch.bfloat16,), timing=False); "
        "cs.check_acc_kernel(fe, (torch.bfloat16,), timing=False)"),
    "flash_attention_bwd.cu": (
        ("flash_attention_fwd.cu", "flash_attention_bwd.cu"),
        "from multimodal_tpu_torch.ops import flash_attention as fa; "
        "cs.check_bwd_kernels(fa, (torch.bfloat16,)); "
        "cs.check_vqa_flash_kernels(fa, (torch.bfloat16,), timing=False)"),
    "fused_mlp_bwd_acc.cu": (
        _MLP_SOURCES,
        "from multimodal_tpu_torch.ops import fused_encoder as fe; "
        "cs.check_acc_kernel(fe, (torch.bfloat16,), timing=False)"),
    "fused_mlp.cu": (
        _MLP_SOURCES,
        "from multimodal_tpu_torch.ops import fused_encoder as fe; "
        "cs.check_mlp_kernel(fe, (torch.bfloat16,), timing=False)"),
}


# A fault's check (build and bf16 cases) ends well inside this: a fault that
# makes a kernel wait forever fails the run instead of holding the card.
PLANTED_FAULT_SECONDS = 300


def fault_readings(case) -> dict:
    """A failed case's readings: its relative errors by output, or its max
    abs error where the case has none (#4)."""
    rel = case.get("rel_err", {"max_abs_err": case["max_abs_err"]})
    return rel if isinstance(rel, dict) else {"out": rel}


def planted_faults() -> None:
    """Each fault of PLANTED_FAULTS in a copy of the package (only the
    sources its checks need, so the copy builds quickly) whose bf16 checks
    of that kernel (#1, #2, #6, the flash backward, #4, #5, #3 or #10) run
    in a process of their own: a fault that no case catches fails the
    run."""
    import shutil
    from pathlib import Path

    root = Path(__file__).resolve().parent
    for n, (name, (source, signature, old, new)) in enumerate(PLANTED_FAULTS.items()):
        keep, check = PLANTED_FAULT_CHECKS[source]
        copy = root / "build" / "planted_faults" / str(n)
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(root / "multimodal_tpu_torch", copy / "multimodal_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(root / "chip_smoke.py", copy / "chip_smoke.py")
        csrc = copy / "multimodal_tpu_torch" / "csrc"
        for src in csrc.glob("*.cu"):
            if src.name not in keep:
                src.unlink()
        cu = csrc / source
        text = cu.read_text()
        start = text.index(signature)
        end = text.index("\n}\n", start)
        if text[start:end].count(old) != 1:
            fail(f"planted fault {name!r}: {old!r} is not once in {signature}")
        cu.write_text(text[:start] + text[start:end].replace(old, new) + text[end:])
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, "-c", "import torch, chip_smoke as cs; " + check], cwd=copy,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                timeout=PLANTED_FAULT_SECONDS)
        except subprocess.TimeoutExpired:
            fail(f"planted fault {name!r}: its check did not end in {PLANTED_FAULT_SECONDS} s")
        checked = [json.loads(line[len("kernel_check "):]) for line in proc.stdout.splitlines()
                   if line.startswith("kernel_check {")]
        caught = [c for c in checked if not c["ok"]]
        print(f"planted fault {name!r}: {len(caught)} of {len(checked)} bf16 cases fail "
              f"({time.perf_counter() - t0:.0f} s): " + json.dumps(
                  {f"{c['kernel']}/{c['case']}": {
                      **{k: round(v, 4) for k, v in fault_readings(c).items()},
                      **({} if c.get("deterministic", True) else {"relaunch": "differs"})}
                   for c in caught}), flush=True)
        if proc.returncode != 0 or not checked:
            fail(f"planted fault {name!r}: the check did not run\n{proc.stdout[-3000:]}")
        if not caught:
            fail(f"planted fault {name!r}: no case caught it")
        shutil.rmtree(copy, ignore_errors=True)


# --------------------------------------------------------------------------
# --ab: kernels #1-#6 and #10, the flash attention backward and the LM
# serving tick, this checkout against another tree
# --------------------------------------------------------------------------

# The main paths' shapes of #3 and of #5, bf16.
AB_MLP = [("flava_image", 64 * 197, 768, 3072, 768, "gelu_exact"),
          ("flava_text", 64 * 77, 768, 3072, 768, "gelu_exact"),
          ("flava_mm", 64 * 275, 768, 3072, 768, "gelu_exact"),
          ("clip_vision", BATCH * 50, 768, 3072, 768, "quick_gelu"),
          ("clip_text", BATCH * 77, 512, 2048, 512, "quick_gelu"),
          ("lm_prefill", 8 * 2048, 768, 3072, 768, "gelu_exact"),
          ("lm_train", 8 * 8192, 768, 3072, 768, "gelu_exact"),
          ("lm_decode", 33, 768, 3072, 768, "gelu_exact")]
AB_ACC = [("flava_image", 64 * 197, 768, 3072, 768, "gelu_exact"),
          ("clip_vision", TRAIN_BATCH * 50, 768, 3072, 768, "quick_gelu"),
          ("lm_train", 8 * 8192, 768, 3072, 768, "gelu_exact")]


def ab_side() -> None:
    """One process of --ab, run with a tree of the repo first on sys.path:
    ms of that tree's #5 at AB_ACC's shapes and of its #3 at AB_MLP's (with
    each stage's, from the profiler, where its kernels have this checkout's
    names, and the host's time a call at the decode tick's rows), of its #4
    at FLAVA's gradient check's 394 image rows and CLIP's 12,800 vision
    rows, of its #6 at the LM's prefill and train shapes (8, 12, 2048 and
    8192, 64) bf16 causal, of its flash attention backward
    (``_flash_backward``: delta, dq, dk and dv) at the LM training shape
    (8, 12, 8192, 64) bf16 causal and (device ms) non-causal at ALBEF's ViT
    (32, 12, 577, 577, 64) and CoCa's pooler (32, 8, 256, 256, 96), of its
    #1 (device ms) at ALBEF's text tower, CLIP's vision (512, 50) and
    causal text (512, 77) towers, ViT-B/16's (256, 197) and CoCa-L's (32,
    256, 3 x 1024), of its #2 at CLIP's vision (256, 50) and causal text
    (256, 77) towers, ViT-B/16's (256, 197) and causal at (256, 256) (the
    `wgmma` kernel), of its #10 at the first four ``QCA_CASES`` (device time
    from the profiler, and the call on the events' clock), of CoCa's fusion
    self-attention both ways (``fusion_route_reading``), and the LM serving
    phase's ms a tick on the host clock and on the device. Prints one
    ``ab`` JSON line."""
    from multimodal_tpu_torch.ops import flash_attention as fa
    from multimodal_tpu_torch.ops import fused_encoder as fe
    from multimodal_tpu_torch.ops import kv_cache as kv
    from multimodal_tpu_torch.ops import quantized_attention as qa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    with torch.inference_mode():
        # #5 first: its times then do not depend on what #3's version left
        # in the allocator and the caches
        for name, rows, din, dff, dout, act in AB_ACC:
            x, g, w1t, b1, w2t = _mlp_bwd_inputs(rows, din, dff, dout, torch.bfloat16, gen)
            fn = lambda: fe.fused_mlp_bwd_acc(x, g, w1t.t(), b1, w2t.t(), act)  # noqa: E731
            out[f"acc_{name}"] = time_ms(fn, reps_for(time_ms(fn, 1)))
            torch.cuda.empty_cache()
        for name, rows, din, dff, dout, act in AB_MLP:
            x, w1t, b1, w2t, b2 = _mlp_inputs(rows, din, dff, dout, torch.bfloat16, gen)
            fn = lambda: fe.fused_mlp(x, w1t.t(), b1, w2t.t(), b2, act)  # noqa: E731
            out[f"mlp_{name}"] = time_ms(fn, reps_for(time_ms(fn, 1)))
            out[f"mlp_{name}_stages"] = stage_ms(fn, MLP_STAGES)
            if rows == 33:  # the host's cost of one call at the decode tick's rows
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    fn()
                out[f"mlp_{name}_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
                torch.cuda.synchronize()
        # #4 at FLAVA's gradient check's image rows and CLIP's vision MLP
        for name, rows, act in (("flava_grad_image", 2 * 197, "gelu_exact"),
                                ("clip_vision", TRAIN_BATCH * 50, "quick_gelu")):
            x, g, w1t, b1, w2t = _mlp_bwd_inputs(rows, 768, 3072, 768, torch.bfloat16, gen)
            fn = lambda: fe.fused_mlp_bwd(x, g, w1t.t(), b1, w2t.t(), act)  # noqa: E731
            out[f"mlp_bwd_{name}"] = time_ms(fn, reps_for(time_ms(fn, 1)))
            torch.cuda.empty_cache()
        # #6 at the LM's prefill call and a train step's call (with lse)
        for name, s in (("prefill", 2048), ("train", 8192)):
            q, k, v = (torch.randn(8, 12, s, 64, device="cuda", generator=gen)
                       .to(torch.bfloat16) for _ in range(3))
            fn = lambda: fa.flash_attention_forward(  # noqa: E731
                q, k, v, causal=True, return_lse=name == "train")
            out[f"flash_fwd_{name}"] = time_ms(fn, reps_for(time_ms(fn, 1)))
            del q, k, v
            torch.cuda.empty_cache()
        q, k, v, do, _, _ = _bwd_inputs(8, 12, 8192, 8192, 64, torch.bfloat16, gen, None, False)
        o, lse = fa.flash_attention_forward(q, k, v, causal=True, return_lse=True)
        fn = lambda: fa._flash_backward(q, k, v, o, lse, do, causal=True,  # noqa: E731
                                        sm_scale=None)
        out["flash_backward_train"] = time_ms(fn, reps_for(time_ms(fn, 1)))
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
        # ALBEF's ViT-B/16 at 384 (D = 64) and CoCa's attention pooler (D = 96),
        # non-causal; device ms from the profiler
        for name, b, h, s, d in (("albef_vit_577", 32, 12, 577, 64),
                                 ("coca_pooler_d96", 32, 8, 256, 96)):
            q, k, v, do, _, _ = _bwd_inputs(b, h, s, s, d, torch.bfloat16, gen, None, False)
            o, lse = fa.flash_attention_forward(q, k, v, return_lse=True)
            fn = lambda: fa._flash_backward(q, k, v, o, lse, do, causal=False,  # noqa: E731
                                            sm_scale=None)
            out[f"flash_backward_{name}"] = device_ms(fn, "flash_attention_bwd")
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
        # #1 at every path's S: ALBEF's text tower (its padding bias),
        # CLIP's vision and (causal) text towers at the serving batch,
        # ViT-B/16's and CoCa-L's vision towers; device ms from the profiler
        # (the calls are host-bound at the small shapes)
        for name, b, s, d, h, causal, key_bias in (
                ("albef_text", 32, 30, 768, 12, False, True),
                ("clip_vision", BATCH, 50, 768, 12, False, False),
                ("clip_text", BATCH, 77, 512, 8, True, False),
                ("vit_b16", TRAIN_BATCH, 197, 768, 12, False, False),
                ("coca_vit_l14", 32, 256, 1024, 16, False, False)):
            qkv, kb = _attention_inputs(b, s, d, torch.bfloat16, key_bias, gen)
            fn = lambda: fe.fused_qkv_attention(qkv, h, causal, None, kb)  # noqa: E731
            out[f"attn_{name}"] = device_ms(fn, "fused_qkv_attention")
            del qkv, kb
            torch.cuda.empty_cache()
        # #2 at CLIP's vision and (causal) text towers and ViT-B/16's vision
        # tower, the train batch
        for name, s, d, h, causal in (("clip_vision", 50, 768, 12, False),
                                      ("clip_text", 77, 512, 8, True),
                                      ("vit_b16", 197, 768, 12, False),
                                      ("causal_256", 256, 768, 12, True)):
            qkv, g, _ = _attention_bwd_inputs(TRAIN_BATCH, s, d, torch.bfloat16, False, gen)
            fn = lambda: fe.fused_qkv_attention_bwd(qkv, g, h, causal)  # noqa: E731
            out[f"attn_bwd_{name}"] = time_ms(fn, reps_for(time_ms(fn, 1)))
            del qkv, g
            torch.cuda.empty_cache()
        # #10 at the four cases of the 4096-position cache
        for name, b, hq, hkv, s, length, d, _ in QCA_CASES[:4]:  # the 4096-long ones
            q, kc, vc, mask = _qca_inputs(qa, kv, b, hq, hkv, s, length, d, torch.bfloat16, gen,
                                          600, 3200)
            fn = lambda: qa.quantized_cache_attention(q, kc, vc, mask)  # noqa: E731
            out[f"qca_{name}"] = device_ms(fn, "quantized_cache_attention")
            out[f"qca_{name}_call"] = time_ms(fn, reps_for(time_ms(fn, 1)))
            del q, kc, vc, mask
            torch.cuda.empty_cache()

    # CoCa's fusion self-attention, forward and backward, both ways
    fusion = fusion_route_reading(fa, torch.Generator(device="cuda").manual_seed(16))
    out.update({f"fusion_{k}": v for k, v in fusion.items() if k.endswith("ms")})
    _, res = lm_serve(fe, fa, qa, card_line())
    out["lm_ms_per_tick"] = res["ms_per_tick"]
    out["lm_device_ms_per_tick"] = res.get("device_ms_per_tick", "not measured")
    print("ab " + json.dumps(out), flush=True)


def sass_by_kernel(lib: str) -> dict:
    """Each flash attention kernel's SASS in the library at ``lib`` (from
    ``cuobjdump``), by its mangled name with the anonymous namespace's
    per-build hashes taken out."""
    import re

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for body in re.split(r"\n\s+Function : ", sass)[1:]:
        name, code = body.split("\n", 1)
        if "flash_" not in name:
            continue
        name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?_cu)_[0-9a-f]{8}", r"\1", name.strip())
        out[name] = code
    return out


def build_trees(parent: str) -> dict:
    """The kernels of another tree of the repo (PARENT) and of this
    checkout, built in parallel, and their flash attention kernels that both
    trees hold compared by their SASS (an ``ab sass`` line). Returns each
    tree's root, by "parent" and "change"."""
    trees = {"parent": Path(parent).resolve(), "change": Path(__file__).resolve().parent}
    t0 = time.perf_counter()
    procs = {n: subprocess.Popen([sys.executable, "-c", f"import sys; sys.path.insert(0, "
                                  f"{str(root)!r}); from multimodal_tpu_torch.ops import _build; "
                                  "print(_build.build())"],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n, root in trees.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            fail(f"--ab: the {name} tree's kernels did not build\n{log[-3000:]}")
        libs[name] = log.strip().splitlines()[-1]
    print(f"ab: built {len(trees)} trees in {time.perf_counter() - t0:.1f} s", flush=True)
    sass = {n: sass_by_kernel(lib) for n, lib in libs.items()}
    both = sorted(set(sass["parent"]) & set(sass["change"]))
    print("ab sass: " + json.dumps({
        "same": [k for k in both if sass["parent"][k] == sass["change"][k]],
        "differ": [k for k in both if sass["parent"][k] != sass["change"][k]],
        "parent_only": sorted(set(sass["parent"]) - set(both)),
        "change_only": sorted(set(sass["change"]) - set(both))}), flush=True)
    return trees


def ab(parent: str) -> None:
    """--ab PARENT: #1-#6, #10, the flash backward and the LM serving tick of
    another tree of the repo (PARENT: the parent commit, unpacked with git
    archive) and of this checkout, each side a process of its own, in turns: parent, checkout,
    checkout, parent, twice, after ``build_trees``."""
    trees = build_trees(parent)

    def run(name, code):
        return [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(trees[name])!r}); "
                + code]

    results = {n: [] for n in trees}
    me = str(Path(__file__).resolve())
    for name in ("parent", "change", "change", "parent") * 2:
        proc = subprocess.run(
            run(name, "import importlib.util as u; "
                      f"s = u.spec_from_file_location('ab_side', {me!r}); "
                      "m = u.module_from_spec(s); s.loader.exec_module(m); "
                      "m.ab_side()"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        lines = [line for line in proc.stdout.splitlines() if line.startswith("ab {")]
        if proc.returncode or not lines:
            fail(f"--ab: the {name} side failed\n{proc.stdout[-3000:]}")
        results[name].append(json.loads(lines[-1][3:]))
        print(f"ab {name}: {lines[-1][3:]}", flush=True)
        for line in proc.stdout.splitlines():
            if line.startswith("lm decode: top host ops"):
                print(f"ab {name} {line}", flush=True)
    first = results["change"][0]
    summary = {k: {n: [r.get(k) for r in rs] for n, rs in results.items()}
               for k, v in first.items() if isinstance(v, float)}
    print("ab summary (each side's runs in order): " + json.dumps(summary), flush=True)


# --------------------------------------------------------------------------
# phase 3: CLIP ViT-B/32 embedding serving
# --------------------------------------------------------------------------


def token_ids(rng, n):
    """(n, 77) ids as CLIP's tokenizer lays them out: SOT, words, EOT (the
    highest id), zero padding."""
    ids = np.zeros((n, 77), dtype=np.int64)
    for i in range(n):
        length = int(rng.integers(3, 76))
        ids[i, 0] = 49406
        ids[i, 1:length] = rng.integers(1, 49405, size=length - 1)
        ids[i, length] = 49407
    return ids


def cosine_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def serve(fe, card):
    from multimodal_tpu_torch.models.clip.model import clip_vit_b32
    from multimodal_tpu_torch.ops.image import fused_preprocess_for_encoder
    from multimodal_tpu_torch.serving.embedding import EmbeddingServer

    t0 = time.perf_counter()
    model = clip_vit_b32(dtype=torch.bfloat16, seed=0)
    print(f"serve: built clip_vit_b32 bf16 in {time.perf_counter() - t0:.2f} s", flush=True)

    def encode_images(u8):
        return model.encode_image(fused_preprocess_for_encoder(u8, 224, dtype=torch.bfloat16))

    image_server = EmbeddingServer(encode_images, max_batch=256)
    text_server = EmbeddingServer(model.encode_text, max_batch=256)

    rng = np.random.default_rng(0)
    sizes = (1, 3, 64, 300)
    requests = [(rng.integers(0, 256, size=(n, 256, 256, 3), dtype=np.uint8),
                 token_ids(rng, n)) for n in sizes]
    # the one-row request reappears as row 0 of the largest: row alignment
    requests[-1][0][0] = requests[0][0][0]
    requests[-1][1][0] = requests[0][1][0]

    fe.reset_launch_counts()
    outs = [(image_server.encode(im), text_server.encode(tx)) for im, tx in requests]
    torch.cuda.synchronize()
    launches = {"fused_qkv_attention": fe.fused_qkv_attention.launches,
                "fused_mlp": fe.fused_mlp.launches}
    forwards = 2 * sum(math.ceil(n / 256) for n in sizes)  # both towers
    want = 12 * forwards
    print(f"serve: launches {launches}, want {want} each ({forwards} tower forwards x 12 layers)",
          flush=True)
    for k, v in launches.items():
        if v != want:
            fail(f"{k} launched {v} times on the main path, want {want}")

    for (im, tx), (ei, et), n in zip(requests, outs, sizes):
        if ei.shape != (n, 512) or et.shape != (n, 512):
            fail(f"request of {n}: embedding shapes {ei.shape}, {et.shape}")
        scores = ei @ et.T
        if not (np.isfinite(ei).all() and np.isfinite(et).all() and np.isfinite(scores).all()):
            fail(f"request of {n}: non-finite embeddings or scores")
        norms = np.linalg.norm(ei, axis=-1)
        if np.abs(norms - 1).max() > 1e-2:
            fail(f"request of {n}: image embeddings not unit norm ({norms.min()}..{norms.max()})")
    align = min(cosine_rows(outs[0][0][:1], outs[-1][0][:1]).min(),
                cosine_rows(outs[0][1][:1], outs[-1][1][:1]).min())
    print(f"serve: row alignment cosine (1-row request vs row 0 of 300) {align:.6f}", flush=True)
    if align < 0.999:
        fail(f"row alignment cosine {align} < 0.999")

    # 4 image and 4 text rows against the same weights in fp32 on the CPU
    ref_model = clip_vit_b32(device="cpu", dtype=torch.float32)
    ref_model.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    im, tx = requests[2]
    with torch.inference_mode():
        ref_i = ref_model.encode_image(fused_preprocess_for_encoder(
            torch.from_numpy(im[:4]), 224, dtype=torch.float32)).numpy()
        ref_t = ref_model.encode_text(torch.from_numpy(tx[:4])).numpy()
    cos_i = cosine_rows(outs[2][0][:4], ref_i)
    cos_t = cosine_rows(outs[2][1][:4], ref_t)
    min_cos = float(min(cos_i.min(), cos_t.min()))
    print(f"serve: cosine vs fp32 CPU: image {cos_i.round(6).tolist()} text "
          f"{cos_t.round(6).tolist()} min {min_cos:.6f} (bar 0.999)", flush=True)
    if min_cos < 0.999:
        fail(f"served embeddings reach cosine {min_cos} < 0.999 against fp32")

    # throughput at batch 512: device-resident inputs, and through the servers
    u8 = torch.from_numpy(rng.integers(0, 256, size=(BATCH, 256, 256, 3), dtype=np.uint8)).cuda()
    ids_np = token_ids(rng, BATCH)
    ids = torch.from_numpy(ids_np).cuda()

    def step():
        return encode_images(u8), model.encode_text(ids)

    with torch.inference_mode():
        step()
        torch.cuda.synchronize()
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        device_rate = BATCH * iters / (time.perf_counter() - t0)
        breakdown = profile_step(step, "serve")
    host_u8 = u8.cpu().numpy()
    t0 = time.perf_counter()
    image_server.encode(host_u8)
    text_server.encode(ids_np)
    served_rate = BATCH / (time.perf_counter() - t0)
    print(f"serve: {device_rate:.1f} pairs/s at batch {BATCH} on device-resident inputs; "
          f"{served_rate:.1f} pairs/s through the servers from host arrays "
          f"(max_batch 256) on {card}", flush=True)
    print("serve: device time by kernel at batch 512 " + json.dumps(breakdown), flush=True)
    return launches, min_cos, device_rate, served_rate


def vit_l14_check(card):
    """CLIP ViT-L/14's image tower (S = 257, beyond the fused kernels) on the
    card at batch 8 in bf16 against the same weights in fp32 on the CPU."""
    from multimodal_tpu_torch.models.clip.model import clip_vit_l14
    from multimodal_tpu_torch.ops.image import fused_preprocess_for_encoder

    model = clip_vit_l14(dtype=torch.bfloat16, seed=0)
    u8 = torch.from_numpy(np.random.default_rng(3).integers(0, 256, size=(8, 256, 256, 3),
                                                            dtype=np.uint8))
    with torch.inference_mode():
        got = model.encode_image(fused_preprocess_for_encoder(u8.cuda(), 224,
                                                              dtype=torch.bfloat16))
        torch.cuda.synchronize()
        ref_model = clip_vit_l14(device="cpu", dtype=torch.float32)
        ref_model.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
        ref = ref_model.encode_image(fused_preprocess_for_encoder(u8, 224, dtype=torch.float32))
    got = got.float().cpu().numpy()
    if got.shape != (8, 768) or not np.isfinite(got).all():
        fail(f"clip_vit_l14 image embeddings {got.shape}, finite {np.isfinite(got).all()}")
    cos = float(cosine_rows(got, ref.numpy()).min())
    print(f"vit_l14: image tower at S=257 on the card, min cosine vs fp32 CPU {cos:.6f} "
          "(bar 0.999)", flush=True)
    if cos < 0.999:
        fail(f"clip_vit_l14 embeddings reach cosine {cos} < 0.999 against fp32")
    return cos


# --------------------------------------------------------------------------
# phase 5: long-context LM serving (continuous batching, int8 KV cache)
# --------------------------------------------------------------------------

LM = dict(vocab_size=32768, max_seq_len=4096, n_layer=12, d_model=768, n_head=12,
          dim_feedforward=3072)  # bench.py's serving model


def lm_requests(rng, n):
    from multimodal_tpu_torch.serving.engine import Request

    out = []
    for i in range(n):
        length = int(rng.integers(600, 3001))  # buckets 1024, 2048 and 4096
        out.append(Request(rng.integers(0, LM["vocab_size"], size=length).tolist(),
                           max_new_tokens=int(rng.integers(32, 129)),
                           temperature=0.0 if i % 2 == 0 else 1.0, request_id=i))
    return out


def teacher_forced(model, prompt, feed, device):
    """Logits at the prompt's last position and at each of ``feed``'s
    decode steps: the prompt's keys and values go into a one-row int8 cache,
    then the fed tokens decode over it, as the engine does."""
    from multimodal_tpu_torch.ops.kv_cache import quantized_kv_zeros
    from multimodal_tpu_torch.serving.engine import _kv_set_rows

    length = 2048
    toks = torch.tensor([prompt], device=device)
    with torch.inference_mode():
        logits, kvs = model(toks, use_cache=True)
        rows = [logits[0, -1].float().cpu()]
        shape = (1, LM["n_head"], length, LM["d_model"] // LM["n_head"])
        cache = tuple((quantized_kv_zeros(shape, device), quantized_kv_zeros(shape, device))
                      for _ in range(LM["n_layer"]))
        slot = torch.zeros(1, dtype=torch.long, device=device)
        for (ck, cv), (k, v) in zip(cache, kvs):
            _kv_set_rows(ck, k, slot, len(prompt))
            _kv_set_rows(cv, v, slot, len(prompt))
        ar = torch.arange(length, device=device)
        for t, tok in enumerate(feed):
            pos = torch.tensor([len(prompt) + t], device=device)
            logits, _ = model(torch.tensor([[tok]], device=device), positions=pos[:, None],
                              past_key_values=cache, cache_index=pos,
                              attention_mask=(ar <= pos)[None, None, None, :], use_cache=True)
            rows.append(logits[0, 0].float().cpu())
    return torch.stack(rows).double()


def lm_serve(fe, fa, qa, card):
    from multimodal_tpu_torch.examples.long_context.model import long_context_lm
    from multimodal_tpu_torch.serving.engine import InferenceEngine

    t0 = time.perf_counter()
    model = long_context_lm(dtype=torch.bfloat16, seed=0, **LM)
    print(f"lm: built LongContextLM {LM} bf16 in {time.perf_counter() - t0:.2f} s", flush=True)
    engine_kw = dict(n_slots=32, max_len=4096, cache_dtype="int8", prefill_batch=8,
                     decode_steps=16, top_k=50)
    rng = np.random.default_rng(4)

    # warm-up: one request per bucket through a throwaway engine
    warm = InferenceEngine(model, **engine_kw)
    for r in lm_requests(rng, 3):
        r.max_new_tokens = 16
        warm.submit(r)
    warm.run()
    del warm
    torch.cuda.synchronize()

    engine = InferenceEngine(model, **engine_kw)
    timing = {"prefill": 0.0, "decode": 0.0}

    def timed(name, fn):
        def run(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            timing[name] += time.perf_counter() - t
            return out
        return run

    engine._prefill = timed("prefill", engine._prefill)
    engine._decode = timed("decode", engine._decode)
    reqs = lm_requests(rng, 48)
    fe.reset_launch_counts()
    fa.reset_launch_counts()
    qa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    outs = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.flash_attention_forward.launches,
                "quantized_cache_attention": qa.quantized_cache_attention.launches,
                "fused_mlp": fe.fused_mlp.launches}
    calls, ticks, layers = engine.prefill_calls, engine.ticks, LM["n_layer"]
    want = {"flash_attention": layers * calls, "quantized_cache_attention": layers * ticks,
            "fused_mlp": layers * (calls + ticks)}
    print(f"lm: launches {launches}, want {want} ({calls} prefill calls, {ticks} decode ticks, "
          f"{layers} layers)", flush=True)
    for k, v in launches.items():
        if v != want[k]:
            fail(f"{k} launched {v} times on the LM serving path, want {want[k]}")
    by_id = {o.request_id: o for o in outs}
    if len(by_id) != len(reqs):
        fail(f"{len(by_id)} of {len(reqs)} requests finished")
    for r in reqs:
        o = by_id[r.request_id]
        if o.finish_reason != "length" or len(o.tokens) != r.max_new_tokens:
            fail(f"request {r.request_id}: {o.finish_reason}, {len(o.tokens)} of "
                 f"{r.max_new_tokens} tokens")
        if not all(0 <= t < LM["vocab_size"] for t in o.tokens):
            fail(f"request {r.request_id}: token ids out of range")
    peak = torch.cuda.max_memory_allocated()
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    decoded = sum(len(o.tokens) - 1 for o in outs)  # the first token comes from the prefill
    ttft = sorted(o.queue_time + o.prefill_time for o in outs)
    stats = engine.stats()
    result = {
        "requests": len(reqs), "prompt_tokens": prompt_tokens, "generated_tokens": decoded + len(outs),
        "prefill_calls": calls, "decode_ticks": ticks, "occupancy": stats["occupancy"],
        "prefill_tokens_per_s": prompt_tokens / timing["prefill"],
        "decode_tokens_per_s": decoded / timing["decode"],
        "ms_per_tick": timing["decode"] / ticks * 1e3,
        "prefill_s": timing["prefill"], "decode_s": timing["decode"], "wall_s": wall,
        "ttft_p50_s": ttft[len(ttft) // 2],
        "prefill_time_p50_s": sorted(o.prefill_time for o in outs)[len(outs) // 2],
        "peak_gib": peak / 2 ** 30,
    }
    print("lm: serving " + json.dumps(result) + f" on {card}", flush=True)

    # accuracy: 2 requests teacher-forced, card bf16 against fp32 on the CPU
    ref = long_context_lm(device="cpu", dtype=torch.float32, **LM)
    ref.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    worst = 1.0
    for r in (reqs[0], reqs[1]):
        prompt = list(r.prompt[:700 + 400 * r.request_id])
        feed = by_id[r.request_id].tokens[:8]
        a = teacher_forced(model, prompt, feed, "cuda")
        b = teacher_forced(ref, prompt, feed, "cpu")
        cos = ((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min().item()
        worst = min(worst, cos)
        print(f"lm: teacher-forced logits, prompt {len(prompt)} + 8 decode steps, min cosine "
              f"vs fp32 CPU {cos:.6f}", flush=True)
    print("lm: bar 0.99: bf16 activations through 12 layers (each rounding 2^-9 relative), "
          "probabilities rounded to bf16 in #6 and #10, and int8 codes that can differ by one "
          "step where the bf16 keys and values differ from the fp32 ones", flush=True)
    if worst < 0.99:
        fail(f"LM logits reach cosine {worst} < 0.99 against fp32")

    # device time of one prefill call (bucket 2048) and one decode call by group
    n = engine.prefill_batch
    dev = engine.device
    tokens = torch.from_numpy(rng.integers(0, LM["vocab_size"], size=(n, 2048))).to(dev)
    slots = torch.arange(n, device=dev)
    lengths = torch.full((n,), 2000, device=dev)
    sampling = torch.tensor([[0.0, 50.0, 1.0]] * n, device=dev)
    prefill_groups = profile_step(lambda: engine._prefill(tokens, slots, lengths, sampling),
                                  "lm prefill")
    rows = engine.n_slots + 1
    dtok = torch.from_numpy(rng.integers(0, LM["vocab_size"], size=rows)).to(dev)
    dpos = torch.full((rows,), 2100, device=dev)
    dsamp = torch.tensor([[0.0, 50.0, 1.0]] * rows, device=dev)
    decode_groups = profile_step(lambda: engine._decode(dtok, dpos, torch.ones_like(dpos), dsamp,
                                                        False), "lm decode")
    print("lm: device time of one prefill call (8 x 2048) by kernel group "
          + json.dumps(prefill_groups), flush=True)
    print("lm: device time of one decode call (16 ticks x 33 rows at position 2100) by kernel "
          "group " + json.dumps(decode_groups), flush=True)
    result.update(min_cosine=worst, prefill_profile=prefill_groups, decode_profile=decode_groups)
    if isinstance(decode_groups, dict):  # device time against the host clock's ms a tick
        result["device_ms_per_tick"] = decode_groups["total_device_ms"] / engine.decode_steps
    return launches, result


def kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in name:
        return "flash_attention"
    if "flash_bwd" in name:  # #9: its `wgmma` kernel, the dq bodies' kDbias = true instances
        return ("flash_attention_bwd_dbias" if "dbias" in name or "true" in name
                else "flash_attention_bwd")
    if "quantized_cache_attention" in name:
        return "quantized_cache_attention"
    if "qkv_attention_bwd" in name:
        return "fused_qkv_attention_bwd"
    if "qkv_attention" in name:
        return "fused_qkv_attention"
    if "fused_mlp_bwd_acc" in name:  # #5's four stages
        return "fused_mlp_bwd_acc"
    if "fused_mlp_bwd_" in name:  # #4's stages
        return "fused_mlp_bwd"
    if "fused_mlp_kernel" in name or "fused_mlp_fwd_" in name:  # #3: fp32; bf16's stages
        return "fused_mlp"
    if "fprop" in low or "implicit_gemm" in low:  # cuDNN's convolutions
        return "conv"
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma")):
        return "library_gemm"
    if "batch_norm" in low:
        return "batch_norm"
    if "avg_pool" in low:
        return "pool"
    if "layer_norm" in low:
        return "layer_norm"
    if "conv" in low or "wgrad" in low or "dgrad" in low:
        return "conv"
    if "upsample" in low or "interp" in low:
        return "resize"
    if "adam" in low or "multi_tensor" in low:
        return "optimizer"
    if "softmax" in low:
        return "softmax"
    if "embedding" in low:
        return "embedding"
    if "reduce" in low:
        return "reduce"
    return "other"


def annotated_kernels(prof, names):
    """(annotation, kernel name, us) of every kernel launched under a
    ``record_function`` range named in ``names``: each kernel hangs on the
    CPU op that launched it, whose ancestors hold the range."""
    out = []
    for e in prof.events():
        kernels = getattr(e, "kernels", None)
        if not kernels or e.device_type.name != "CPU":
            continue
        anc = e.cpu_parent
        while anc is not None and anc.name not in names:
            anc = anc.cpu_parent
        if anc is not None:
            out += [(anc.name, k.name, k.duration) for k in kernels]
    return out


def profile_step(step, label: str, annotations=()):
    """Device time of one ``step()``, summed by kernel group, from
    torch.profiler; 'not measured' when the profiler sees no device time.
    The kernels launched under a ``record_function`` range named in
    ``annotations`` form a group of that name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, top = {}, []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if not us or e.device_type.name != "CUDA" or getattr(e, "is_user_annotation", False):
            continue  # annotations (Optimizer.step#...) span kernels counted on their own
        g = kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        top.append((round(us / 1e3, 3), e.key[:90]))
    if not groups:
        return "not measured"
    carved = annotated_kernels(prof, set(annotations)) if annotations else []
    for tag, name, us in carved:
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) - us / 1e3
        groups[tag] = groups.get(tag, 0.0) + us / 1e3
    for tag in annotations:
        if tag not in groups:
            groups[tag] = 0.0
            print(f"{label}: no kernel found under the {tag!r} range", flush=True)
    print(f"{label}: top kernels (ms) " + json.dumps(sorted(top, reverse=True)[:12]), flush=True)
    host = sorted(((round(e.self_cpu_time_total / 1e3, 3), e.count, e.key[:60])
                   for e in prof.key_averages() if e.self_cpu_time_total > 0), reverse=True)
    print(f"{label}: top host ops (self ms, calls) " + json.dumps(host[:10]), flush=True)
    out = {k: round(v, 3) for k, v in sorted(groups.items(), key=lambda kv: -kv[1])}
    out["total_device_ms"] = round(sum(groups.values()), 3)
    out["wall_ms_under_profiler"] = round(wall_ms, 3)
    return out


# --------------------------------------------------------------------------
# phase 4: CLIP ViT-B/32 contrastive train step
# --------------------------------------------------------------------------


def clip_loss_fn(dtype):
    """bench.py's loss_fn: uint8 images -> preprocess -> both towers ->
    contrastive loss at logit scale 4.6052."""
    from multimodal_tpu_torch.modules.losses.contrastive_loss_with_temperature import (
        contrastive_loss_with_temperature,
    )
    from multimodal_tpu_torch.ops.image import fused_preprocess_for_encoder

    def loss_fn(model, batch):
        images_u8, text = batch
        out = model(fused_preprocess_for_encoder(images_u8, 224, dtype=dtype), text)
        return contrastive_loss_with_temperature(
            out.embeddings_a, out.embeddings_b, 4.6052).loss, {}

    return loss_fn


def mlp_bwd_launches(fe):
    """Launches of the two MLP backward kernels since the last reset."""
    return {"fused_mlp_bwd": fe.fused_mlp_bwd.launches,
            "fused_mlp_bwd_acc": fe.fused_mlp_bwd_acc.launches}


def mlp_bwd_routes(fe, mlps):
    """The launches of #4 and #5 that MLP backwards make, each taking the
    route ``fused_mlp_bwd_acc_supported`` gives its shape: ``mlps`` holds
    (rows, Din, Dff, Dout, count)."""
    out = {"fused_mlp_bwd": 0, "fused_mlp_bwd_acc": 0}
    for rows, din, dff, dout, count in mlps:
        acc = fe.fused_mlp_bwd_acc_supported(rows, din, dff, dout)
        out["fused_mlp_bwd_acc" if acc else "fused_mlp_bwd"] += count
    return out


def grad_cosines(model, batch, build=None):
    """Cosines of the card's bf16 gradients against an fp32 step of the
    same weights (a model from ``build``, CLIP ViT-B/32 by default) on the
    CPU through the plain versions: the concatenated gradient's, and the
    lowest single tensor's with its name."""
    from multimodal_tpu_torch.models.clip.model import clip_vit_b32

    build = build or clip_vit_b32
    model.zero_grad(set_to_none=True)
    loss, _ = clip_loss_fn(torch.bfloat16)(model, tuple(t.cuda() for t in batch))
    loss.backward()
    loss = loss.detach()
    ref = build(device="cpu", dtype=torch.float32)
    ref.load_state_dict({k: v.detach().float().cpu() for k, v in model.state_dict().items()})
    ref_loss, _ = clip_loss_fn(torch.float32)(ref, batch)
    ref_loss.backward()
    ref_loss = ref_loss.detach()
    ref_grads = dict(ref.named_parameters())
    dots = sq_a = sq_b = 0.0
    worst = (2.0, "")
    for name, p in model.named_parameters():
        a = p.grad.double().cpu().flatten()
        b = ref_grads[name].grad.double().flatten()
        dots += float(a @ b)
        sq_a += float(a @ a)
        sq_b += float(b @ b)
        cos = float(a @ b) / max(float(a.norm() * b.norm()), 1e-300)
        worst = min(worst, (cos, name))
    model.zero_grad(set_to_none=True)
    return dots / math.sqrt(sq_a * sq_b), worst, loss.item(), ref_loss.item()


def train(fe, card):
    from multimodal_tpu_torch.models.clip.model import clip_vit_b32
    from multimodal_tpu_torch.training.trainer import Trainer

    t0 = time.perf_counter()
    model = clip_vit_b32(dtype=torch.bfloat16, param_dtype=torch.float32, seed=0).train()
    print(f"train: built clip_vit_b32 (fp32 params, bf16 compute) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    rng = np.random.default_rng(1)
    small = (torch.from_numpy(rng.integers(0, 256, size=(8, 256, 256, 3), dtype=np.uint8)),
             torch.from_numpy(token_ids(rng, 8)))
    t0 = time.perf_counter()
    fe.reset_launch_counts()
    cos, (worst_cos, worst_name), loss_card, loss_cpu = grad_cosines(model, small)
    check_launches = mlp_bwd_launches(fe)
    print(f"train: gradient cosine vs fp32 CPU at 8 pairs: {cos:.6f} (bar 0.99); lowest "
          f"tensor {worst_name} {worst_cos:.6f}; loss card {loss_card:.6f} cpu {loss_cpu:.6f} "
          f"({time.perf_counter() - t0:.1f} s); MLP backward launches {check_launches}",
          flush=True)
    if not cos >= 0.99:
        fail(f"gradient cosine {cos} < 0.99 against fp32 on the CPU")
    # 8 pairs are 400 and 616 rows a tower, 12 layers each
    want = mlp_bwd_routes(fe, ((8 * 50, 768, 3072, 768, 12), (8 * 77, 512, 2048, 512, 12)))
    if check_launches != want:
        fail(f"MLP backward launches in the 8-pair gradient check: {check_launches}, "
             f"want {want}")

    warmup, steps = 2, 10
    batches = [(rng.integers(0, 256, size=(TRAIN_BATCH, 256, 256, 3), dtype=np.uint8),
                token_ids(rng, TRAIN_BATCH)) for _ in range(warmup + steps + 1)]
    # optax.adamw(1e-4): weight decay 1e-4 on every parameter; PyTorch's
    # single-kernel (fused) AdamW
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4, fused=True)
    # no log boundary inside the window: the metrics reach the host at the
    # last step of a fit only (the losses are printed below)
    trainer = Trainer(clip_loss_fn(torch.bfloat16), opt, log_interval=100)
    # two warm-up steps: the prefetch's two pinned host buffers exist before
    # the timed window
    trainer.fit(model, batches[:warmup], warmup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fe.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit(model, batches[warmup:warmup + steps], steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"fused_qkv_attention": fe.fused_qkv_attention.launches,
                "fused_qkv_attention_bwd": fe.fused_qkv_attention_bwd.launches,
                "fused_mlp": fe.fused_mlp.launches, **mlp_bwd_launches(fe)}
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in trainer.logger.records if "loss" in r]
    # 24 a step (12 layers x 2 towers); the MLP backward by the predicate
    want = {k: 24 * steps for k in launches}
    want.update(mlp_bwd_routes(fe, ((TRAIN_BATCH * 50, 768, 3072, 768, 12 * steps),
                                    (TRAIN_BATCH * 77, 512, 2048, 512, 12 * steps))))
    print(f"train: launches {launches}, want {want}", flush=True)
    for k, v in launches.items():
        if v != want[k]:
            fail(f"{k} launched {v} times in {steps} train steps, want {want[k]}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    rate = TRAIN_BATCH * steps / dt
    print(f"train: {rate:.1f} items/s, {dt / steps * 1e3:.1f} ms a step at batch {TRAIN_BATCH} "
          f"(host batches, prefetched), peak memory {peak / 2**30:.2f} GiB, losses "
          f"{[round(x, 5) for x in losses]} on {card}", flush=True)
    breakdown = profile_step(lambda: trainer.fit(model, batches[-1:], 1), "train")
    print("train: device time of one step by kernel group " + json.dumps(breakdown), flush=True)
    launches["fused_mlp_bwd_grad_check"] = check_launches["fused_mlp_bwd"]
    return launches, cos, rate, dt / steps * 1e3, peak


def vit_b16_grad_check(fe, card):
    """CLIP ViT-B/16's gradients (vision S = 197: kernel #2 past S = 128) at
    2 pairs, fp32 parameters and bf16 compute on the card, against fp32 on
    the CPU: concatenated cosine >= 0.99 with #2 launched. Then its train
    step at batch 256 (AdamW, as the ViT-B/32 phase): 1 warm-up and 3 timed
    steps with 24 launches a step of #1 and #2, and one step's device time
    by kernel group."""
    from multimodal_tpu_torch.models.clip.model import clip_vit_b16
    from multimodal_tpu_torch.training.trainer import Trainer

    model = clip_vit_b16(dtype=torch.bfloat16, param_dtype=torch.float32, seed=0).train()
    rng = np.random.default_rng(4)
    pairs = (torch.from_numpy(rng.integers(0, 256, size=(2, 256, 256, 3), dtype=np.uint8)),
             torch.from_numpy(token_ids(rng, 2)))
    t0 = time.perf_counter()
    fe.reset_launch_counts()
    cos, (worst_cos, worst_name), loss_card, loss_cpu = grad_cosines(model, pairs, clip_vit_b16)
    launches = {"fused_qkv_attention": fe.fused_qkv_attention.launches,
                "fused_qkv_attention_bwd": fe.fused_qkv_attention_bwd.launches}
    print(f"vit_b16: gradient cosine vs fp32 CPU at 2 pairs: {cos:.6f} (bar 0.99); lowest "
          f"tensor {worst_name} {worst_cos:.6f}; loss card {loss_card:.6f} cpu {loss_cpu:.6f} "
          f"({time.perf_counter() - t0:.1f} s); attention launches {launches} on {card}",
          flush=True)
    if not cos >= 0.99:
        fail(f"ViT-B/16 gradient cosine {cos} < 0.99 against fp32 on the CPU")
    # 12 layers x 2 towers; the vision tower's 12 at S = 197
    if launches["fused_qkv_attention_bwd"] != 24:
        fail(f"ViT-B/16 gradient check: #2 launched {launches['fused_qkv_attention_bwd']} "
             "times, want 24")

    warmup, steps = 1, 3
    batches = [(rng.integers(0, 256, size=(TRAIN_BATCH, 256, 256, 3), dtype=np.uint8),
                token_ids(rng, TRAIN_BATCH)) for _ in range(warmup + steps + 1)]
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4, fused=True)
    trainer = Trainer(clip_loss_fn(torch.bfloat16), opt, log_interval=100)
    trainer.fit(model, batches[:warmup], warmup)
    torch.cuda.synchronize()
    fe.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit(model, batches[warmup:warmup + steps], steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    step_launches = {"fused_qkv_attention": fe.fused_qkv_attention.launches,
                     "fused_qkv_attention_bwd": fe.fused_qkv_attention_bwd.launches}
    losses = [r["loss"] for r in trainer.logger.records if "loss" in r]
    print(f"vit_b16: train {TRAIN_BATCH * steps / dt:.1f} items/s, {dt / steps * 1e3:.1f} ms a "
          f"step at batch {TRAIN_BATCH}, launches {step_launches}, losses "
          f"{[round(x, 5) for x in losses]} on {card}", flush=True)
    for k, v in step_launches.items():
        if v != 24 * steps:
            fail(f"ViT-B/16 train: {k} launched {v} times in {steps} steps, want {24 * steps}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"ViT-B/16 train: non-finite loss: {losses}")
    breakdown = profile_step(lambda: trainer.fit(model, batches[-1:], 1), "vit_b16")
    print("vit_b16: device time of one train step by kernel group " + json.dumps(breakdown),
          flush=True)
    del model, trainer, opt
    torch.cuda.empty_cache()
    return launches, cos, step_launches, dt / steps * 1e3


# --------------------------------------------------------------------------
# phase 7: long-context LM training (kernels #6-#8, #3, #4)
# --------------------------------------------------------------------------

LM_TRAIN = dict(vocab_size=32000, max_seq_len=8192, n_layer=12, d_model=768, n_head=12,
                dim_feedforward=3072)  # the training recipe's defaults
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 8192


def lm_grad_cosine(model, trainer, batch):
    """Cosine of the card's gradients (bf16 compute) against an fp32 step of
    the same weights on the CPU through the plain versions, both through the
    recipe's loss: the concatenated gradient's, and the lowest single
    tensor's with its name."""
    from multimodal_tpu_torch.examples.long_context import train as lt
    from multimodal_tpu_torch.examples.long_context.model import long_context_lm

    model.zero_grad(set_to_none=True)
    loss, _ = trainer.loss_fn(model, {k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    loss.backward()
    ref = long_context_lm(device="cpu", dtype=torch.float32, **LM_TRAIN).train()
    ref.load_state_dict({k: v.detach().float().cpu() for k, v in model.state_dict().items()})
    ref_loss, _ = lt.build_trainer(ref).loss_fn(ref, {k: torch.from_numpy(v)
                                                      for k, v in batch.items()})
    ref_loss.backward()
    ref_grads = dict(ref.named_parameters())
    dots = sq_a = sq_b = 0.0
    worst = (2.0, "")
    for name, p in model.named_parameters():
        a = p.grad.double().cpu().flatten()
        b = ref_grads[name].grad.double().flatten()
        dots += float(a @ b)
        sq_a += float(a @ a)
        sq_b += float(b @ b)
        worst = min(worst, (float(a @ b) / max(float(a.norm() * b.norm()), 1e-300), name))
    model.zero_grad(set_to_none=True)
    return dots / math.sqrt(sq_a * sq_b), worst, loss.item(), ref_loss.item()


def lm_train(fe, fa, card):
    """The recipe at its defaults through ``build_trainer`` and
    ``Trainer.fit``: fp32 parameters, bf16 compute, remat, clipping + AdamW,
    synthetic token windows at batch 8 x 8192; then ``main`` itself with
    packed documents."""
    from multimodal_tpu_torch.examples.long_context import train as lt
    from multimodal_tpu_torch.examples.long_context.model import long_context_lm

    t0 = time.perf_counter()
    model = long_context_lm(dtype=torch.bfloat16, param_dtype=torch.float32, seed=0, remat=True,
                            **LM_TRAIN)
    n_params = sum(p.numel() for p in model.parameters())
    trainer = lt.build_trainer(model, log_interval=100)
    print(f"lm train: built LongContextLM {LM_TRAIN} ({n_params / 1e6:.1f}M parameters, fp32, "
          f"bf16 compute, remat) in {time.perf_counter() - t0:.2f} s", flush=True)

    # the row of a packed batch of 4 that holds the most documents
    packed = next(lt.packed_document_batches(None, LM_TRAIN["vocab_size"], 1024, 4, seed=0))
    row = int(packed["segment_ids"].max(axis=1).argmax())
    packed = {k: v[row:row + 1] for k, v in packed.items()}
    n_docs = int(packed["segment_ids"].max())
    t0 = time.perf_counter()
    fe.reset_launch_counts()
    cos, (worst_cos, worst_name), loss_card, loss_cpu = lm_grad_cosine(model, trainer, packed)
    check_launches = mlp_bwd_launches(fe)
    print(f"lm train: gradient cosine vs fp32 CPU, one packed row of 1024 tokens ({n_docs} "
          f"documents, segment ids on), {LM_TRAIN['n_layer']} layers: {cos:.6f} (bar 0.99); "
          f"lowest tensor "
          f"{worst_name} {worst_cos:.6f}; loss card {loss_card:.6f} cpu {loss_cpu:.6f} "
          f"({time.perf_counter() - t0:.1f} s); MLP backward launches {check_launches}",
          flush=True)
    if not cos >= 0.99:
        fail(f"LM gradient cosine {cos} < 0.99 against fp32 on the CPU")
    # one packed row is 1,024 rows: #4's side of the predicate
    if check_launches != mlp_bwd_routes(fe, ((1024, 768, 3072, 768, LM_TRAIN["n_layer"]),)):
        fail(f"MLP backward launches in the LM gradient check: {check_launches}")

    warmup, steps = 2, 5
    stream = lt.synthetic_tokens(LM_TRAIN["vocab_size"], LM_TRAIN_BATCH * LM_TRAIN_SEQ * 64)
    data = lt.token_batches(lt.TokenWindowDataset(stream, LM_TRAIN_SEQ), LM_TRAIN_BATCH)
    batches = [next(data) for _ in range(warmup + steps + 1)]
    trainer.fit(model, batches[:warmup], warmup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fe.reset_launch_counts()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit(model, batches[warmup:warmup + steps], steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {"flash_attention": fa.flash_attention_forward.launches,
                "flash_attention_bwd": fa.flash_attention_bwd.launches,
                "flash_attention_bwd_dbias": fa.flash_attention_bwd_dbias.launches,
                "fused_mlp": fe.fused_mlp.launches, **mlp_bwd_launches(fe)}
    layers = LM_TRAIN["n_layer"]
    # forward and remat recompute: 2 a layer; backward: 1; #9 only for a
    # differentiated bias; the MLP backward of 65,536 rows by the predicate
    want = {"flash_attention": 2 * layers * steps, "flash_attention_bwd": layers * steps,
            "flash_attention_bwd_dbias": 0, "fused_mlp": 2 * layers * steps,
            **mlp_bwd_routes(fe, ((LM_TRAIN_BATCH * LM_TRAIN_SEQ, 768, 3072, 768,
                                   layers * steps),))}
    print(f"lm train: launches {launches}, want {want} ({steps} steps, {layers} layers)",
          flush=True)
    for k, v in launches.items():
        if v != want[k]:
            fail(f"{k} launched {v} times in {steps} LM train steps, want {want[k]}")
    losses = [r["loss"] for r in trainer.logger.records[-steps:]]
    skipped = [r["nonfinite_skipped"] for r in trainer.logger.records[-steps:]]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses) or any(skipped):
        fail(f"LM train losses {losses}, skipped {skipped}")
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ * steps
    result = {"tokens_per_s": tokens / dt, "ms_per_step": dt / steps * 1e3,
              "peak_gib": peak / 2 ** 30, "losses": losses, "grad_cosine": cos,
              "grad_cosine_lowest": [worst_name, worst_cos]}
    print(f"lm train: {tokens / dt:.1f} tokens/s, {dt / steps * 1e3:.1f} ms a step at batch "
          f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} (host batches, prefetched), peak memory "
          f"{peak / 2 ** 30:.2f} GiB, losses {[round(x, 5) for x in losses]} on {card}",
          flush=True)
    breakdown = profile_step(lambda: trainer.fit(model, batches[-1:], 1), "lm train")
    print("lm train: device time of one step by kernel group " + json.dumps(breakdown),
          flush=True)
    result["profile"] = breakdown
    del model, trainer, batches
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model, trainer = lt.main(["--packed-docs", "synthetic", "--steps", "2", "--bf16"])
    torch.cuda.synchronize()
    cli_losses = [r["loss"] for r in trainer.logger.records]
    print(f"lm train: main(--packed-docs synthetic --steps 2 --bf16) at batch 8 x 8192: losses "
          f"{[round(x, 5) for x in cli_losses]} in {time.perf_counter() - t0:.1f} s", flush=True)
    if len(cli_losses) != 2 or not all(math.isfinite(x) for x in cli_losses):
        fail(f"the packed CLI run's losses {cli_losses}")
    result["cli_packed_losses"] = cli_losses
    del model, trainer
    torch.cuda.empty_cache()
    launches["fused_mlp_bwd_grad_check"] = check_launches["fused_mlp_bwd"]
    return launches, result


# --------------------------------------------------------------------------
# phase 8: FLAVA pretraining (kernels #3, #5 and #4)
# --------------------------------------------------------------------------

FLAVA_BATCH = 64
FLAVA_SEQS = (("image", 197), ("text", 77), ("mm", 275))  # rows a pair of each tower's MLP
FLAVA_MLPS = 12 * 2 + 12 * 2 + 6  # image and text towers twice a step, multimodal once


def flava_mlp_bwd_routes(fe, batch):
    """#4's and #5's launches in one FLAVA step at ``batch`` pairs."""
    rows = dict(FLAVA_SEQS)
    return mlp_bwd_routes(fe, ((batch * rows["image"], 768, 3072, 768, 24),
                               (batch * rows["text"], 768, 3072, 768, 24),
                               (batch * rows["mm"], 768, 3072, 768, 6)))


def flava_cfg(batch: int, steps: int, bf16: bool = True):
    """The recipe's config at its defaults (``base``: image 224/16, text 77,
    vocab 30522) at ``batch``; ``steps`` sets the schedule's length."""
    from multimodal_tpu_torch.examples.flava import pretrain as fp
    from multimodal_tpu_torch.utils.config import build_config

    return build_config(None, [f"data.batch_size={batch}", f"train.steps={steps}",
                               f"model.bf16={bf16}", "train.log_interval=100"],
                        defaults=fp.DEFAULTS)


def flava_grad_cosine(model, batch, replay_codebook=False):
    """Cosine of the card's gradients (bf16 compute) against an fp32 step of
    the same weights on the CPU through the plain versions, both through the
    recipe's loss summed over ``batch`` (one batch or a list): the
    concatenated gradient's, and the lowest single tensor's with its name.
    Parameters the batches do not reach have no gradient on either side.
    With ``replay_codebook`` the CPU model takes the card's dVAE labels (the
    bf16 codebook's argmax flips on near-ties; ``dvae_check`` holds it)."""
    from multimodal_tpu_torch.examples.flava import pretrain as fp

    batches = batch if isinstance(batch, list) else [batch]

    def total(m, device):
        loss = 0.0
        for b in batches:
            loss = loss + fp.loss_fn(m, {k: torch.as_tensor(v).to(device)
                                         for k, v in b.items()})[0]
        return loss

    labels = []
    codebook = model.image_codebook
    if replay_codebook:
        codebook.forward = lambda x: labels.append(type(codebook).forward(codebook, x)) \
            or labels[-1]
    model.zero_grad(set_to_none=True)
    loss = total(model, next(model.parameters()).device)
    loss.backward()
    if replay_codebook:
        del codebook.forward
    ref = fp.build_model(flava_cfg(2, 1, bf16=False), device="cpu")
    ref.load_state_dict({k: v.detach().float().cpu() for k, v in model.state_dict().items()})
    if replay_codebook:
        ref.image_codebook.forward = lambda x: labels.pop(0).cpu()
    ref_loss = total(ref, "cpu")
    ref_loss.backward()
    ref_grads = dict(ref.named_parameters())
    dots = sq_a = sq_b = 0.0
    worst = (2.0, "")
    for name, p in model.named_parameters():
        if (p.grad is None) != (ref_grads[name].grad is None):
            fail(f"FLAVA gradient of {name}: present on one side only")
        if p.grad is None:
            continue
        a = p.grad.double().cpu().flatten()
        b = ref_grads[name].grad.double().flatten()
        dots += float(a @ b)
        sq_a += float(a @ a)
        sq_b += float(b @ b)
        if a.any() or b.any():  # a head the batch reaches only through `sum() * 0` has none
            worst = min(worst, (float(a @ b) / max(float(a.norm() * b.norm()), 1e-300), name))
    model.zero_grad(set_to_none=True)
    return dots / math.sqrt(sq_a * sq_b), worst, loss.item(), ref_loss.item()


def flava_train(fe, fa, card):
    """The FLAVA recipe at ``base`` (12 image, 12 text and 6 multimodal
    layers, width 768, ffn 3072, fp32 parameters, bf16 compute, the recipe's
    AdamW and schedule) through ``build_trainer_and_state`` and
    ``Trainer.fit`` on the recipe's synthetic batches at batch 64: the
    gradients of 2 pairs against fp32 on the CPU, then 2 warm-up and 5
    timed steps; then the recipe's ``main``."""
    from multimodal_tpu_torch.examples.flava import pretrain as fp

    warmup, steps = 2, 5
    cfg = flava_cfg(FLAVA_BATCH, warmup + steps)
    t0 = time.perf_counter()
    model = fp.build_model(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    trainer, model = fp.build_trainer_and_state(cfg, model=model)
    print(f"flava: built FLAVAForPreTraining base ({n_params / 1e6:.1f}M parameters, fp32, "
          f"bf16 compute) in {time.perf_counter() - t0:.2f} s", flush=True)

    def counts():
        return {"fused_qkv_attention": fe.fused_qkv_attention.launches,
                "fused_qkv_attention_bwd": fe.fused_qkv_attention_bwd.launches,
                "fused_mlp": fe.fused_mlp.launches, **mlp_bwd_launches(fe),
                "flash_attention": fa.flash_attention_forward.launches}

    small = next(fp.synthetic_batches(flava_cfg(2, 1)))
    t0 = time.perf_counter()
    fe.reset_launch_counts()
    fa.reset_launch_counts()
    cos, (worst_cos, worst_name), loss_card, loss_cpu = flava_grad_cosine(model, small)
    check_launches = counts()
    print(f"flava: gradient cosine vs fp32 CPU at 2 pairs: {cos:.6f} (bar 0.99); lowest tensor "
          f"{worst_name} {worst_cos:.6f}; loss card {loss_card:.6f} cpu {loss_cpu:.6f} "
          f"({time.perf_counter() - t0:.1f} s); launches {check_launches}", flush=True)
    if not cos >= 0.99:
        fail(f"FLAVA gradient cosine {cos} < 0.99 against fp32 on the CPU")
    # 2 pairs are 394, 154 and 550 rows; the towers ask for attention
    # probabilities, so no fused or flash attention
    want = dict.fromkeys(check_launches, 0)
    want.update(fused_mlp=FLAVA_MLPS, **flava_mlp_bwd_routes(fe, 2))
    if check_launches != want:
        fail(f"FLAVA gradient check launches {check_launches}, want {want}")

    data = fp.synthetic_batches(cfg)
    batches = [next(data) for _ in range(warmup + steps + 1)]
    trainer.fit(model, batches[:warmup], warmup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fe.reset_launch_counts()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit(model, batches[warmup:warmup + steps], steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = counts()
    want = dict.fromkeys(launches, 0)
    want.update(fused_mlp=FLAVA_MLPS * steps,
                **{k: v * steps for k, v in flava_mlp_bwd_routes(fe, FLAVA_BATCH).items()})
    print(f"flava: launches {launches}, want {want} ({steps} steps, {FLAVA_MLPS} MLPs a step)",
          flush=True)
    if launches != want:
        fail(f"FLAVA train launches {launches}, want {want}")
    records = trainer.logger.records[-steps:]
    names = ("loss", "itm_loss", "mmm_text_loss", "mmm_image_loss", "global_contrastive_loss")
    if (len(records) != steps or any(r["nonfinite_skipped"] for r in records)
            or not all(math.isfinite(r[k]) for r in records for k in names)):
        fail(f"FLAVA train losses {records}")
    losses = [r["loss"] for r in records]
    result = {"items_per_s": FLAVA_BATCH * steps / dt, "ms_per_step": dt / steps * 1e3,
              "peak_gib": peak / 2 ** 30, "losses": losses,
              "last_step": {k: records[-1][k] for k in names}, "grad_cosine": cos,
              "grad_cosine_lowest": [worst_name, worst_cos]}
    print(f"flava: {result['items_per_s']:.1f} items/s, {result['ms_per_step']:.1f} ms a step "
          f"at batch {FLAVA_BATCH} (host batches, prefetched), peak memory "
          f"{result['peak_gib']:.2f} GiB, losses {[round(x, 5) for x in losses]}, last step "
          f"{json.dumps(result['last_step'])} on {card}", flush=True)
    breakdown = profile_step(lambda: trainer.fit(model, batches[-1:], 1), "flava")
    print("flava: device time of one step by kernel group " + json.dumps(breakdown),
          flush=True)
    result["profile"] = breakdown
    del model, trainer, batches, data
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model, trainer = fp.main([f"data.batch_size={FLAVA_BATCH}", "train.steps=2"])
    torch.cuda.synchronize()
    cli_losses = [r["loss"] for r in trainer.logger.records]
    print(f"flava: main(data.batch_size={FLAVA_BATCH} train.steps=2): losses "
          f"{[round(x, 5) for x in cli_losses]} in {time.perf_counter() - t0:.1f} s", flush=True)
    if len(cli_losses) != 2 or not all(math.isfinite(x) for x in cli_losses):
        fail(f"the FLAVA CLI run's losses {cli_losses}")
    result["cli_losses"] = cli_losses
    del model, trainer
    torch.cuda.empty_cache()
    launches["fused_mlp_bwd_grad_check"] = check_launches["fused_mlp_bwd"]
    return launches, result


# --------------------------------------------------------------------------
# phase 9: FLAVA from real data
# --------------------------------------------------------------------------

REAL_PAIRS = 256  # the seeded local dataset's image-text pairs
REAL_WORDS = ("a photo of the cat dog bird car tree sky red blue green small big on under "
              "over near two three sits runs flies parked old new bright dark").split()
RESUME_TOL = 1e-6  # |loss difference| / max(1, |loss|) of a resumed step
DVAE_IMAGES = 8  # codebook views in the dVAE check
DVAE_MIN_LABELS = 5  # distinct fp32 labels the check needs for its agreement to tell
IMAGE_KEYS = ("image", "image_for_codebook", "image_patches_mask")
TEXT_KEYS = ("text", "text_masked", "mlm_labels")


def mosaic(r: np.random.RandomState, size: int = 256, cells: int = 16) -> np.ndarray:
    """A uint8 (size, size, 3) image of cells x cells squares of random
    colours, each flat or overlaid with noise of amplitude 20 or 80: local
    content that differs from place to place, as a photo's does, so that
    the dVAE's labels differ across positions (on noise they hardly do)."""
    k = np.ones((size // cells, size // cells, 1))
    colours = np.kron(r.randint(0, 256, (cells, cells, 3)).astype(np.float32), k)
    amp = np.kron(r.choice([0.0, 20.0, 80.0], (cells, cells, 1)), k)
    noise = amp * r.uniform(-1, 1, (size, size, 3))
    return np.clip(colours + noise, 0, 255).astype(np.uint8)


def write_real_data(root: str) -> dict:
    """The phase's seeded local data under ``root``: a jsonl of 256
    {image: .npy uint8 256x256x3 (``mosaic``), text, label} pairs (the pretraining and
    the labelled finetuning set), an image folder of 64 .npy images in two
    class directories with a jsonl index (the zero-shot set) and a jsonl of
    128 of the pairs (the COCO retrieval set)."""
    r = np.random.RandomState(12)
    os.makedirs(os.path.join(root, "images"))
    rows = []
    for i in range(REAL_PAIRS):
        path = os.path.join(root, "images", f"{i:04d}.npy")
        np.save(path, mosaic(r))
        rows.append({"image": path, "text": " ".join(r.choice(REAL_WORDS, r.randint(5, 16))),
                     "label": int(r.randint(2))})
    paths = {"pairs": os.path.join(root, "pairs.jsonl"), "coco": os.path.join(root, "coco.jsonl"),
             "imagenet": os.path.join(root, "imagenet.jsonl")}
    for name, part in (("pairs", rows), ("coco", rows[:128])):
        with open(paths[name], "w") as f:
            f.writelines(json.dumps(row) + "\n" for row in part)
    # two class directories, named after ImageNet's classes 0 and 1, and
    # their index with those labels: a sample without a class name takes the
    # eval's full protocol (1,000 class names x 80 templates)
    folder = os.path.join(root, "imagenet")
    with open(paths["imagenet"], "w") as f:
        for label, c in enumerate(("tench", "goldfish")):
            os.makedirs(os.path.join(folder, c))
            for i in range(32):
                path = os.path.join(folder, c, f"{i:02d}.npy")
                np.save(path, mosaic(r))
                f.write(json.dumps({"image": path, "label": label}) + "\n")
    return paths


def real_cfg(paths: dict, batch: int, steps: int, *extra: str):
    from multimodal_tpu_torch.examples.flava import pretrain as fp
    from multimodal_tpu_torch.utils.config import build_config

    return build_config(None, [f"data.path={paths['pairs']}", f"data.batch_size={batch}",
                               f"train.steps={steps}", "train.log_interval=100", *extra],
                        defaults=fp.DEFAULTS)


def real_args(paths: dict, batch: int, steps: int, *extra: str) -> list:
    return [f"data.path={paths['pairs']}", f"data.batch_size={batch}", f"train.steps={steps}",
            "train.log_interval=100", *extra]


def dvae_check(model, batch):
    """The bf16 dVAE on the card against an fp32 copy on the CPU over
    ``DVAE_IMAGES`` codebook views: the logits' cosine, the cosine of the
    logits less each channel's mean over an image's positions (the spatial
    part, which a common mode cannot carry), the labels' agreement and the
    count of distinct fp32 labels."""
    from multimodal_tpu_torch.models.flava.dalle_vae import DalleVAEEncoder

    x = batch["image_for_codebook"][:DVAE_IMAGES]
    with torch.no_grad():
        got = model.image_codebook.encoder(x.cuda()).float().cpu()
    ref = DalleVAEEncoder()
    ref.load_state_dict({k: v.float().cpu() for k, v in model.image_codebook.state_dict().items()})
    with torch.no_grad():
        want = ref.encoder(x)

    def cosine(a, b):
        return float(F.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0))

    centred = cosine(got - got.mean((1, 2), keepdim=True), want - want.mean((1, 2), keepdim=True))
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return (cosine(got, want), centred, agree, tuple(got.shape),
            int(want.argmax(-1).unique().numel()))


def record_dvae(model):
    """Wraps the codebook's forward in a ``dvae`` profiler range."""
    from torch.profiler import record_function

    codebook = model.image_codebook

    def forward(x):
        with record_function("dvae"):
            return type(codebook).forward(codebook, x)

    codebook.forward = forward


def flava_real(fe, fa, card):
    """Phase 9: the FLAVA recipes from a seeded local dataset at ``base``
    (see the module docstring)."""
    from multimodal_tpu_torch.examples.flava import coco_zero_shot as coco
    from multimodal_tpu_torch.examples.flava import finetune as ff
    from multimodal_tpu_torch.examples.flava import pretrain as fp

    phase_t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="flava_real_")
    try:
        return _flava_real(fe, fa, card, fp, ff, coco, root, phase_t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _flava_real(fe, fa, card, fp, ff, coco, root, phase_t0):
    def counts():
        return {"fused_qkv_attention": fe.fused_qkv_attention.launches,
                "fused_qkv_attention_bwd": fe.fused_qkv_attention_bwd.launches,
                "fused_mlp": fe.fused_mlp.launches, **mlp_bwd_launches(fe),
                "flash_attention": fa.flash_attention_forward.launches}

    def reset():
        fe.reset_launch_counts()
        fa.reset_launch_counts()

    def expect(label, got, mlps, forward=None):
        """``mlps``: (rows, Din, Dff, Dout, count) of the MLP backwards;
        ``forward``: the forwards, when more than the backwards."""
        want = dict.fromkeys(got, 0)
        want.update(fused_mlp=forward or sum(n for *_, n in mlps), **mlp_bwd_routes(fe, mlps))
        print(f"flava_real {label}: launches {json.dumps(got)}, want {json.dumps(want)}",
              flush=True)
        if got != want:
            fail(f"flava_real {label}: launches {got}, want {want}")

    t0 = time.perf_counter()
    paths = write_real_data(root)
    result = {"write_s": time.perf_counter() - t0}
    print(f"flava_real: wrote {REAL_PAIRS} pairs (.npy 256x256x3 mosaics), a 2-class folder of 64 "
          f"images and 128 caption pairs in {result['write_s']:.1f} s", flush=True)

    # the host transform alone (crop, bicubic 224 + Lanczos 112, mask): in
    # one thread, and on the data modules' pool as a batch goes through it
    from multimodal_tpu_torch.data.datamodules import _pixel_pool

    cfg = real_cfg(paths, FLAVA_BATCH, 7)
    transform = fp.flava_train_transform(cfg)
    images = [np.load(os.path.join(root, "images", f"{i:04d}.npy")) for i in range(64)]
    transform.transform(images[0])  # builds the C++ resampler
    t0 = time.perf_counter()
    for img in images:
        transform.transform(img)
    result["host_ms_per_image"] = (time.perf_counter() - t0) / len(images) * 1e3
    pool = _pixel_pool()
    t0 = time.perf_counter()
    for f in [pool.submit(transform.plan(img)) for img in images]:
        f.result()
    result["pool_ms_per_image"] = (time.perf_counter() - t0) / len(images) * 1e3
    print(f"flava_real: host transform {result['host_ms_per_image']:.2f} ms an image in one "
          f"thread, {result['pool_ms_per_image']:.2f} on the pool's {pool._max_workers} "
          f"threads (64 images, C++ resampling)", flush=True)

    trainer, model = fp.build_trainer_and_state(cfg)
    data = fp.real_batches(cfg)
    first = next(data)

    # accuracy: the dVAE, then the six-loss gradient at 2 pairs
    cos, centred, agree, shape, distinct = dvae_check(model, first)
    result.update(dvae_cosine=cos, dvae_centred_cosine=centred, dvae_label_agreement=agree,
                  dvae_distinct_labels=distinct)
    print(f"flava_real: dVAE logits {shape} bf16 card vs fp32 CPU, {DVAE_IMAGES} images: "
          f"cosine {cos:.6f} (bar 0.999), less each channel's mean over positions "
          f"{centred:.6f} (bar 0.999), labels agree {agree:.4f}, {distinct} distinct fp32 "
          f"labels among {shape[0] * shape[1] * shape[2]} (bar {DVAE_MIN_LABELS}; random "
          f"weights)", flush=True)
    if not (cos >= 0.999 and centred >= 0.999):
        fail(f"dVAE logit cosine {cos} (less channel means {centred}) < 0.999 against fp32 "
             f"on the CPU")
    if distinct < DVAE_MIN_LABELS:
        fail(f"the dVAE check's fp32 labels take {distinct} values, fewer than "
             f"{DVAE_MIN_LABELS}: their agreement tells nothing")
    vl = next(fp.real_batches(real_cfg(paths, 2, 1)))
    six = [vl, {k: vl[k] for k in IMAGE_KEYS}, {k: vl[k] for k in TEXT_KEYS}]
    reset()
    t0 = time.perf_counter()
    gcos, (worst_cos, worst_name), loss_card, loss_cpu = flava_grad_cosine(
        model, six, replay_codebook=True)
    check_launches = counts()
    print(f"flava_real: six-loss gradient cosine vs fp32 CPU at 2 pairs (image-text, image-only "
          f"and text-only batches, the card's dVAE labels on both sides): {gcos:.6f} (bar "
          f"0.99); lowest tensor {worst_name} {worst_cos:.6f}; loss card {loss_card:.6f} cpu "
          f"{loss_cpu:.6f} ({time.perf_counter() - t0:.1f} s)", flush=True)
    if not gcos >= 0.99:
        fail(f"FLAVA six-loss gradient cosine {gcos} < 0.99 against fp32 on the CPU")
    # the image-text batch's 54 MLPs, 24 each of the unimodal batches; the
    # unmasked pass of an image-only or text-only batch feeds no loss, so 12
    # of each unimodal batch's MLPs have no backward
    rows = dict(FLAVA_SEQS)
    expect("gradient check", check_launches, (
        (2 * rows["image"], 768, 3072, 768, 24 + 12), (2 * rows["text"], 768, 3072, 768, 24 + 12),
        (2 * rows["mm"], 768, 3072, 768, 6)), forward=FLAVA_MLPS + 24 + 24)
    result.update(grad_cosine=gcos, grad_cosine_lowest=[worst_name, worst_cos])

    # timed: 2 warm-up and 5 steps on the real-data stream
    step_mlps = ((FLAVA_BATCH * rows["image"], 768, 3072, 768, 24),
                 (FLAVA_BATCH * rows["text"], 768, 3072, 768, 24),
                 (FLAVA_BATCH * rows["mm"], 768, 3072, 768, 6))
    trainer.fit(model, data, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    trainer.fit(model, data, 5)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = counts()
    expect("5 timed steps", launches, tuple((r, a, b, c, n * 5) for r, a, b, c, n in step_mlps))
    records = trainer.logger.records[-5:]
    names = ("loss", "itm_loss", "mmm_text_loss", "mmm_image_loss", "global_contrastive_loss")
    if (len(records) != 5 or any(r["nonfinite_skipped"] for r in records)
            or not all(math.isfinite(r[k]) for r in records for k in names)):
        fail(f"FLAVA real-data losses {records}")
    result.update(items_per_s=FLAVA_BATCH * 5 / dt, ms_per_step=dt / 5 * 1e3,
                  peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  losses=[r["loss"] for r in records],
                  last_step={k: records[-1][k] for k in names})
    print(f"flava_real: {result['items_per_s']:.1f} items/s, {result['ms_per_step']:.1f} ms a "
          f"step at batch {FLAVA_BATCH} (real data: draws on the prefetch thread, resampling on "
          f"the pool), "
          f"peak memory {result['peak_gib']:.2f} GiB, losses "
          f"{[round(x, 5) for x in result['losses']]}, last step "
          f"{json.dumps(result['last_step'])} on {card}", flush=True)
    record_dvae(model)
    breakdown = profile_step(lambda: trainer.fit(model, data, 3), "flava_real",
                             annotations=("dvae",))
    del model.image_codebook.forward
    if isinstance(breakdown, dict):
        result["idle_share"] = 1 - breakdown["total_device_ms"] / breakdown["wall_ms_under_profiler"]
        breakdown = {k: round(v / 3, 3) for k, v in breakdown.items()}
    print(f"flava_real: device time of a step by kernel group (3 real-data steps under the "
          f"profiler, divided by 3) {json.dumps(breakdown)}; idle share "
          f"{result.get('idle_share', float('nan')):.4f}", flush=True)
    result["profile"] = breakdown

    # what holds the step: the stream alone, then the step on batches drawn
    # beforehand
    stream = fp.real_batches(cfg, start_step=100)
    next(stream)
    time.sleep(2.0)  # its prefetch queue full: the 10 batches below include 2 made ahead
    t0 = time.perf_counter()
    ready = [next(stream) for _ in range(10)][-5:]
    result["stream_ms_per_batch"] = (time.perf_counter() - t0) / 8 * 1e3
    del stream
    time.sleep(2.0)  # the stream's thread fills its queue again, then waits
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit(model, ready, 5)
    torch.cuda.synchronize()
    result["ms_per_step_drawn_before"] = (time.perf_counter() - t0) / 5 * 1e3
    print(f"flava_real: the stream alone {result['stream_ms_per_batch']:.1f} ms a batch of "
          f"{FLAVA_BATCH}; the step on batches drawn beforehand "
          f"{result['ms_per_step_drawn_before']:.1f} ms", flush=True)

    # MIM and MLM: an image-only and a text-only step at batch 64
    batch = next(data)
    trainer.fit(model, [{k: batch[k] for k in IMAGE_KEYS}], 1)
    trainer.fit(model, [{k: batch[k] for k in TEXT_KEYS}], 1)
    mim, mlm = trainer.logger.records[-2]["mim_loss"], trainer.logger.records[-1]["mlm_loss"]
    result["six_losses"] = {**result["last_step"], "mim_loss": mim, "mlm_loss": mlm}
    del result["six_losses"]["loss"]
    print(f"flava_real: the six losses at batch {FLAVA_BATCH}: "
          f"{json.dumps(result['six_losses'])}", flush=True)
    if not (math.isfinite(mim) and math.isfinite(mlm)):
        fail(f"FLAVA MIM / MLM losses {mim} {mlm}")
    del model, trainer, data, batch, first
    torch.cuda.empty_cache()

    # checkpoint and resume: 7 steps saved every 3, the step-6 save taken
    # away (a run killed after step 3's save), a second main resumes at 3
    ckpt = os.path.join(root, "ckpt")
    args = real_args(paths, FLAVA_BATCH, 7, f"train.checkpoint_dir={ckpt}",
                     "train.checkpoint_every=3")
    t0 = time.perf_counter()
    _, whole = fp.main(args)
    whole_s = time.perf_counter() - t0
    full = {r["step"]: r for r in whole.logger.records}
    del whole
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(ckpt, "6"))
    t0 = time.perf_counter()
    _, resumed = fp.main(args)
    resumed_s = time.perf_counter() - t0
    got = {r["step"]: r for r in resumed.logger.records}
    del resumed
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt)
    if sorted(got) != [4, 5, 6, 7]:
        fail(f"the resumed run logged steps {sorted(got)}, want 4-7")
    diffs = {s: max(abs(got[s][k] - full[s][k]) / max(1.0, abs(full[s][k])) for k in names)
             for s in got}
    result["resume"] = {"max_rel_diff_by_step": diffs,
                        "bitwise": all(got[s][k] == full[s][k] for s in got for k in names),
                        "whole_s": whole_s, "resumed_s": resumed_s}
    print(f"flava_real: resume at step 3 of 7: steps 4-7 against the uninterrupted run, "
          f"largest |diff| / max(1, |loss|) by step {json.dumps(diffs)} (bar {RESUME_TOL}), "
          f"bitwise {result['resume']['bitwise']}; runs {whole_s:.1f} s and {resumed_s:.1f} s "
          f"(checkpoints of the model, AdamW's state and the trainer's)", flush=True)
    if not max(diffs.values()) <= RESUME_TOL:
        fail(f"FLAVA resumed losses differ by {diffs}")

    # pure bf16 with both evals through train.eval_every
    evals = {}

    def timed(name, build):
        def build_timed(cfg_):
            fn = build(cfg_)

            def eval_fn(m):
                before = counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(m)
                torch.cuda.synchronize()
                evals[name] = {"seconds": time.perf_counter() - t, "metrics": out,
                               "launches": {k: v - before[k] for k, v in counts().items()}}
                return out

            return eval_fn

        return build_timed

    build_zs, build_coco = fp.build_zero_shot_eval, coco.build_coco_eval
    fp.build_zero_shot_eval = timed("zero_shot", build_zs)
    coco.build_coco_eval = timed("coco", build_coco)
    reset()
    try:
        model, trainer = fp.main(real_args(
            paths, FLAVA_BATCH, 3, "train.pure_bf16=true", f"data.imagenet_path={paths['imagenet']}",
            f"data.coco_path={paths['coco']}", "train.eval_every=3",
            f"data.eval_batch_size={FLAVA_BATCH}"))
    finally:
        fp.build_zero_shot_eval, coco.build_coco_eval = build_zs, build_coco
    total = counts()
    bf16_launches = {k: v - sum(e["launches"][k] for e in evals.values()) for k, v in total.items()}
    expect("pure bf16, 3 steps", bf16_launches,
           tuple((r, a, b, c, n * 3) for r, a, b, c, n in step_mlps))
    bf16_losses = [r["loss"] for r in trainer.logger.records if "loss" in r]
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    print(f"flava_real: pure bf16 (AnyPrecision AdamW, parameter dtypes {dtypes}): losses "
          f"{[round(x, 5) for x in bf16_losses]}", flush=True)
    if len(bf16_losses) != 3 or not all(math.isfinite(x) for x in bf16_losses):
        fail(f"pure bf16 losses {bf16_losses}")
    result["pure_bf16_losses"] = bf16_losses
    del model, trainer
    torch.cuda.empty_cache()
    # the zero-shot eval: 16 text forwards (64 classes x 80 templates a
    # call) and one batch of 64 images; COCO: 2 batches of 64 pairs
    for name, text_calls, image_calls in (("zero_shot", 16, 1), ("coco", 2, 2)):
        e = evals.get(name)
        if e is None:
            fail(f"the {name} eval did not run")
        want = dict.fromkeys(e["launches"], 0)
        want["fused_mlp"] = 12 * (text_calls + image_calls)
        print(f"flava_real: {name} eval in {e['seconds']:.2f} s: {json.dumps(e['metrics'])}; "
              f"launches {json.dumps(e['launches'])}", flush=True)
        if e["launches"] != want:
            fail(f"the {name} eval launched {e['launches']}, want {want}")
        if not all(0.0 <= v <= 1.0 for v in e["metrics"].values()):
            fail(f"the {name} eval's metrics {e['metrics']}")
    result["evals"] = {k: {"seconds": v["seconds"], **v["metrics"]} for k, v in evals.items()}

    # finetuning at base from the labelled pairs: 3 steps, then a resumed run to 5
    ftdir = os.path.join(root, "finetune")
    ft_args = [f"data.path={paths['pairs']}", f"train.checkpoint_dir={ftdir}",
               "train.log_interval=100"]
    t0 = time.perf_counter()
    _, ft = ff.main(ft_args + ["train.steps=3"])
    ft_first = [r["loss"] for r in ft.logger.records]
    del ft
    torch.cuda.empty_cache()
    reset()
    _, ft = ff.main(ft_args + ["train.steps=5"])
    ft_launches = counts()
    ft_steps = [r["step"] for r in ft.logger.records]
    ft_losses = ft_first + [r["loss"] for r in ft.logger.records]
    b = ff.DEFAULTS["data"]["batch_size"]
    # a step: both image passes (the masked one, with no mask, feeds no
    # loss: no backward), the text pass and the unmasked multimodal pass
    expect("finetune, 2 resumed steps", ft_launches, (
        (b * rows["image"], 768, 3072, 768, 12 * 2), (b * rows["text"], 768, 3072, 768, 12 * 2),
        (b * rows["mm"], 768, 3072, 768, 6 * 2)), forward=(24 + 12 + 6) * 2)
    print(f"flava_real: finetune at base, batch {b}, fp32: steps 1-3, then resumed at "
          f"{ft.step - len(ft_steps)} for steps {ft_steps}: losses "
          f"{[round(x, 5) for x in ft_losses]} in {time.perf_counter() - t0:.1f} s", flush=True)
    if ft_steps != [4, 5] or not all(math.isfinite(x) for x in ft_losses):
        fail(f"finetune steps {ft_steps}, losses {ft_losses}")
    result["finetune_losses"] = ft_losses
    del ft
    torch.cuda.empty_cache()
    result["wall_s"] = time.perf_counter() - phase_t0
    print(f"flava_real: phase {result['wall_s']:.1f} s", flush=True)
    paths_launches = {"flava_real": launches, "flava_real_pure_bf16": bf16_launches,
                      "flava_real_finetune": ft_launches,
                      "flava_real_grad_check": {"fused_mlp_bwd": check_launches["fused_mlp_bwd"]},
                      **{f"flava_real_{k}_eval": v["launches"] for k, v in evals.items()}}
    return paths_launches, result


# --------------------------------------------------------------------------
# phase 10: CLIP zero-shot classification from strings and images
# --------------------------------------------------------------------------

MERGES = Path(__file__).resolve().parent / "tests" / "assets" / "clip_merges.bpe"
ZS_BATCH = 256  # the text server's max_batch and the eval's image batch
ZS_IMAGES = 4096
ZS_CLASSES_A_CALL = 64  # build_zero_shot_classifier's batch_size
ZS_COSINE = 0.999
LATENCY_BATCH = 32  # scripts/bench_latency.py's
LATENCY_RUNS = 20


def zs_counts(fe, fa) -> dict:
    return {"fused_qkv_attention": fe.fused_qkv_attention.launches,
            "fused_mlp": fe.fused_mlp.launches,
            "flash_attention": fa.flash_attention_forward.launches}


def zs_reset(fe, fa) -> None:
    fe.reset_launch_counts()
    fa.reset_launch_counts()


def zs_expect(label: str, got: dict, want: dict) -> None:
    print(f"zero_shot {label}: launches {json.dumps(got)}, want {json.dumps(want)}", flush=True)
    for k, v in want.items():
        if got[k] != v:
            fail(f"zero_shot {label}: {k} launched {got[k]} times, want {v}")


def text_forwards(n_classes: int, n_templates: int) -> int:
    """Text tower forwards of ``build_zero_shot_classifier`` through a server
    of ``ZS_BATCH`` rows: each call encodes 64 classes' prompts."""
    return sum(math.ceil(min(ZS_CLASSES_A_CALL, n_classes - i) * n_templates / ZS_BATCH)
               for i in range(0, n_classes, ZS_CLASSES_A_CALL))


def randomize_batch_norms(model, seed: int) -> None:
    """Every BatchNorm scale, bias and running statistic drawn from ``seed``:
    with the init's zero bn3 scales the bottleneck branches would add
    nothing, and no check would see them."""
    from multimodal_tpu_torch.models.clip.resnet_encoder import Fp32BatchNorm2d

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Fp32BatchNorm2d):
                n = m.weight.numel()
                m.weight.copy_(torch.rand(n, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)


def zero_shot_model(fe, fa, card, label, model, ref_model, size, transform, images, labels,
                    image_launches):
    """Steps 2-3 of the zero-shot phase for one model: the ImageNet
    classifier (1,000 classes x 80 templates) through a text server, 8 of its
    columns against fp32 on the CPU; then ``imagenet_zero_shot_eval`` over
    ``images`` in batches of 256 through device preprocessing and the image
    tower, and 4 images' logits against fp32 on the CPU. ``image_launches``:
    the kernels one image forward launches."""
    from multimodal_tpu_torch.data.imagenet_zeroshot import (
        imagenet_classnames, imagenet_templates, imagenet_zero_shot_eval)
    from multimodal_tpu_torch.ops.image import fused_preprocess_for_encoder
    from multimodal_tpu_torch.serving.embedding import EmbeddingServer
    from multimodal_tpu_torch.training.zero_shot import build_zero_shot_classifier, logits_against

    classnames, templates = imagenet_classnames(), imagenet_templates()
    n_prompts = len(classnames) * len(templates)
    server = EmbeddingServer(model.encode_text, max_batch=ZS_BATCH)

    def encode_text(ids):
        return torch.from_numpy(server.encode(ids)).cuda()

    text_fwd = text_forwards(len(classnames), len(templates))
    zs_reset(fe, fa)
    t0 = time.perf_counter()
    classifier = build_zero_shot_classifier(encode_text, transform, classnames, templates,
                                            batch_size=ZS_CLASSES_A_CALL)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    classifier_counts = zs_counts(fe, fa)
    zs_expect(f"{label} classifier", classifier_counts,
              {"fused_qkv_attention": 12 * text_fwd, "fused_mlp": 12 * text_fwd,
               "flash_attention": 0})
    if classifier.shape != (model.encoder_b.projection.out_features, len(classnames)) or \
            not torch.isfinite(classifier).all():
        fail(f"zero_shot {label}: classifier {tuple(classifier.shape)}, finite "
             f"{bool(torch.isfinite(classifier).all())}")
    print(f"zero_shot {label}: classifier {tuple(classifier.shape)} from {n_prompts} prompts "
          f"({text_fwd} text forwards of <= {ZS_BATCH} rows) in {build_s:.2f} s, "
          f"{n_prompts / build_s:.1f} prompts/s, tokenizing included, on {card}", flush=True)

    # 8 classes' columns in fp32 on the CPU, the same weights
    pick = np.linspace(0, len(classnames) - 1, 8).round().astype(int)
    with torch.inference_mode():
        ref_cls = build_zero_shot_classifier(ref_model.encode_text, transform,
                                             [classnames[i] for i in pick], templates)
    cls_cos = cosine_rows(classifier[:, pick].T.cpu().numpy(), ref_cls.T.numpy())
    print(f"zero_shot {label}: classifier columns {pick.tolist()} vs fp32 CPU cosine "
          f"{cls_cos.round(6).tolist()} (bar {ZS_COSINE})", flush=True)
    if cls_cos.min() < ZS_COSINE:
        fail(f"zero_shot {label}: classifier column cosine {cls_cos.min()} < {ZS_COSINE}")

    image_s = [0.0]

    def encode_image(u8):
        t0 = time.perf_counter()
        x = fused_preprocess_for_encoder(torch.from_numpy(u8).cuda(), size, dtype=torch.bfloat16)
        emb = model.encode_image(x)
        torch.cuda.synchronize()
        image_s[0] += time.perf_counter() - t0
        return emb

    batches = [{"image": images[i:i + ZS_BATCH], "labels": labels[i:i + ZS_BATCH]}
               for i in range(0, len(images), ZS_BATCH)]
    zs_reset(fe, fa)
    t0 = time.perf_counter()
    with torch.inference_mode():
        acc = imagenet_zero_shot_eval(encode_image, encode_text, transform, batches)
    eval_s = time.perf_counter() - t0
    eval_counts = zs_counts(fe, fa)
    zs_expect(f"{label} eval", eval_counts, {
        k: 12 * text_fwd * (k != "flash_attention") + len(batches) * image_launches.get(k, 0)
        for k in eval_counts})
    images_per_s = len(images) / image_s[0]
    print(f"zero_shot {label}: imagenet_zero_shot_eval over {len(images)} seeded uint8 "
          f"256x256 images with seeded labels in {eval_s:.2f} s (classifier rebuilt inside); "
          f"top1 {acc['top1']:.6f} top5 {acc['top5']:.6f} (random weights and labels: chance, "
          f"0.001 / 0.005, is what to expect); images {images_per_s:.1f}/s (upload, preprocess "
          f"and image tower at batch {ZS_BATCH}) on {card}", flush=True)

    with torch.inference_mode():
        probe = images[:4]
        got = logits_against(encode_image(probe), classifier).float().cpu().numpy()
        ref_emb = ref_model.encode_image(fused_preprocess_for_encoder(
            torch.from_numpy(probe), size, dtype=torch.float32))
        want = logits_against(ref_emb, classifier.float().cpu()).numpy()
    logit_cos = cosine_rows(got, want)
    print(f"zero_shot {label}: logits of 4 images (1,000 classes; fp32 CPU image tower "
          f"against the card's classifier) cosine {logit_cos.round(6).tolist()} "
          f"(bar {ZS_COSINE})", flush=True)
    if logit_cos.min() < ZS_COSINE:
        fail(f"zero_shot {label}: logit cosine {logit_cos.min()} < {ZS_COSINE}")
    breakdown = profile_step(lambda: encode_image(images[:ZS_BATCH]), f"zero_shot {label} image")
    print(f"zero_shot {label}: device time by kernel of one image batch of {ZS_BATCH} "
          + json.dumps(breakdown), flush=True)
    return dict(classifier_launches=classifier_counts, eval_launches=eval_counts,
                prompts_per_s=n_prompts / build_s, build_s=build_s, images_per_s=images_per_s,
                classifier_cosine=float(cls_cos.min()), logit_cosine=float(logit_cos.min()),
                top1=acc["top1"], top5=acc["top5"], image_breakdown=breakdown)


def latency(model, transform, card):
    """``BASELINE.json``'s transform + encode latency as
    ``scripts/bench_latency.py`` defines it: batch 32, uint8 (32, 256, 256,
    3) images and (32, 77) ids on the card, device preprocessing and both
    ViT-B/32 towers, 20 runs on distinct inputs, p50 and p90 of the host
    clock up to a scalar read back; then again from 32 prompt strings, host
    tokenization inside the clock."""
    from multimodal_tpu_torch.data.imagenet_zeroshot import imagenet_classnames, imagenet_templates
    from multimodal_tpu_torch.ops.image import fused_preprocess_for_encoder

    names, templates = imagenet_classnames(), imagenet_templates()
    rng = np.random.default_rng(17)

    def run(u8, text):
        t0 = time.perf_counter()
        with torch.inference_mode():
            ids = text if isinstance(text, torch.Tensor) else transform(text).cuda()
            t1 = time.perf_counter()
            out = model(fused_preprocess_for_encoder(u8, 224, dtype=torch.bfloat16), ids)
            float(out.embeddings_a.float().sum())
        return (time.perf_counter() - t0) * 1e3, (t1 - t0) * 1e3

    result = {}
    for kind in ("ids", "strings"):
        lat, tok = [], []
        for i in range(LATENCY_RUNS + 1):  # the first run warms up
            u8 = torch.from_numpy(rng.integers(0, 256, (LATENCY_BATCH, 256, 256, 3),
                                               dtype=np.uint8)).cuda()
            prompts = [templates[i % len(templates)].format(names[(LATENCY_BATCH * i + j) % 1000])
                       for j in range(LATENCY_BATCH)]
            text = transform(prompts).cuda() if kind == "ids" else prompts
            torch.cuda.synchronize()
            ms, tok_ms = run(u8, text)
            lat.append(ms)
            tok.append(tok_ms)
        lat, tok = sorted(lat[1:]), sorted(tok[1:])
        result[kind] = {"p50_ms": lat[len(lat) // 2], "p90_ms": lat[int(len(lat) * 0.9)]}
        print(f"zero_shot latency from {kind}: transform+encode batch {LATENCY_BATCH}: p50 "
              f"{result[kind]['p50_ms']:.3f} ms, p90 {result[kind]['p90_ms']:.3f} ms, per pair "
              f"p50 {result[kind]['p50_ms'] / LATENCY_BATCH:.4f} ms on {card}; the runs (ms) "
              f"{[round(t, 2) for t in lat]}, of which tokenizing and the ids' upload p50 "
              f"{tok[len(tok) // 2]:.3f} ms", flush=True)
    return result


def zero_shot(fe, fa, card):
    """Phase 10: the ImageNet zero-shot protocol from strings and uint8
    images (see the module docstring)."""
    from multimodal_tpu_torch.data.imagenet_zeroshot import imagenet_classnames, imagenet_templates
    from multimodal_tpu_torch.models.clip import model as clip_model
    from multimodal_tpu_torch.ops.image import fused_preprocess_for_encoder
    from multimodal_tpu_torch.transforms.clip_transform import CLIPTextTransform

    phase_t0 = time.perf_counter()
    # 1. the whole protocol's prompts, native against Python
    prompts = [t.format(c) for c in imagenet_classnames() for t in imagenet_templates()]
    t0 = time.perf_counter()
    native = CLIPTextTransform(str(MERGES), native=True)
    python = CLIPTextTransform(str(MERGES))
    init_s = time.perf_counter() - t0
    bpe = native.tokenizer.bpe
    if bpe.num_merges != 48894:
        fail(f"zero_shot: the tokenizer read {bpe.num_merges} merges, want 48894")
    t0 = time.perf_counter()
    ids_native = native(prompts)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids_python = python(prompts)
    python_s = time.perf_counter() - t0
    equal_rows = int((ids_native == ids_python).all(dim=1).sum())
    print(f"zero_shot tokenize: {len(prompts)} prompts (1,000 classes x 80 templates), "
          f"{equal_rows} id rows of the native tokenizer equal to the Python one's; native "
          f"{native_s:.2f} s ({len(prompts) / native_s:.1f} prompts/s, {bpe.native_calls} "
          f"native calls, {bpe.fallbacks} per-word fallbacks), Python {python_s:.2f} s "
          f"({len(prompts) / python_s:.1f} prompts/s), both cold caches; tokenizers built in "
          f"{init_s:.2f} s; host of the {card} machine", flush=True)
    if equal_rows != len(prompts) or ids_native.shape != (len(prompts), 77):
        fail(f"zero_shot: {len(prompts) - equal_rows} native id rows differ from Python's")

    rng = np.random.default_rng(21)
    images = rng.integers(0, 256, size=(ZS_IMAGES, 256, 256, 3), dtype=np.uint8)
    labels = rng.integers(0, 1000, size=ZS_IMAGES)

    # 2-3. ViT-B/32
    vit = clip_model.clip_vit_b32(dtype=torch.bfloat16, seed=0)
    ref = clip_model.clip_vit_b32(device="cpu", dtype=torch.float32)
    ref.load_state_dict({k: v.float().cpu() for k, v in vit.state_dict().items()})
    out = {"vit_b32": zero_shot_model(fe, fa, card, "vit_b32", vit, ref, 224, native, images,
                                      labels, {"fused_qkv_attention": 12, "fused_mlp": 12})}
    # 4. RN50: its attention pool takes #6 at S = 50, 32 heads of 64
    rn50 = clip_model.clip_rn50(dtype=torch.bfloat16, seed=0)
    randomize_batch_norms(rn50, seed=5)
    ref = clip_model.clip_rn50(device="cpu", dtype=torch.float32)
    ref.load_state_dict({k: v.float().cpu() for k, v in rn50.state_dict().items()})
    out["rn50"] = zero_shot_model(fe, fa, card, "rn50", rn50, ref, 224, native, images, labels,
                                  {"flash_attention": 1})
    del rn50, ref
    # 5. the other ResNet builders at full width, one forward of 2 images each
    builders = {}
    u8 = torch.from_numpy(rng.integers(0, 256, size=(2, 256, 256, 3), dtype=np.uint8)).cuda()
    for name in ("clip_rn101", "clip_rn50x4", "clip_rn50x16", "clip_rn50x64"):
        t0 = time.perf_counter()
        model = getattr(clip_model, name)(dtype=torch.bfloat16, seed=0)
        build_s = time.perf_counter() - t0
        tower = model.encoder_a
        size, dim = tower.input_resolution, tower.attnpool.c_proj.out_features
        zs_reset(fe, fa)
        with torch.inference_mode():
            emb = model.encode_image(fused_preprocess_for_encoder(u8, size, dtype=torch.bfloat16))
            torch.cuda.synchronize()
        counts = zs_counts(fe, fa)
        emb = emb.float().cpu().numpy()
        norms = np.linalg.norm(emb, axis=-1)
        seq = (size // 32) ** 2 + 1
        print(f"zero_shot {name}: built in {build_s:.1f} s, input {size}, attention pool "
              f"(2, {tower.attnpool.num_heads}, {seq}, 64), embeddings {emb.shape}, norms "
              f"{norms.round(4).tolist()}, launches {json.dumps(counts)}", flush=True)
        if emb.shape != (2, dim) or not np.isfinite(emb).all() or np.abs(norms - 1).max() > 1e-2:
            fail(f"zero_shot {name}: embeddings {emb.shape} (want (2, {dim})), norms {norms}")
        zs_expect(name, counts, {"fused_qkv_attention": 0, "fused_mlp": 0, "flash_attention": 1})
        builders[name] = counts
        del model, tower
        torch.cuda.empty_cache()
    out["rn_builders"] = builders
    # 6. BASELINE.json's transform + encode latency, ViT-B/32
    out["latency"] = latency(vit, native, card)
    del vit
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - phase_t0
    print(f"zero_shot: phase wall time {out['wall_s']:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------------
# phase 11: ALBEF retrieval and VQA fine-tuning (ViT-B/16 at 384)
# --------------------------------------------------------------------------

ALBEF_BATCH = 32
ALBEF_IMAGE, ALBEF_PATCH = 384, 16
ALBEF_SEQ = (ALBEF_IMAGE // ALBEF_PATCH) ** 2 + 1  # 577 image tokens
ALBEF_TEXT = 30  # RetrievalTrainingDataModule's text_len, VQADataModule's question_len
ALBEF_QUEUE, ALBEF_EMBED = 65536, 256
ALBEF_TRAIN_IMAGES, ALBEF_EVAL_IMAGES, ALBEF_EVAL_CAPTIONS = 128, 128, 5
ALBEF_K_TEST = 128
VQA_QUESTIONS, VQA_ANSWERS, VQA_ANSWER_LEN = 128, 10, 10
ALBEF_COSINE = 0.999
# the published widths: ViT-B/16, a 6-layer BERT (vocab 30522), 6
# cross-attention layers
ALBEF_WIDTHS = dict(hidden=768, heads=12, mlp=3072, vit_layers=12, text_layers=6,
                    mm_layers=6, vocab=30522)
ALBEF_KERNELS = ("fused_qkv_attention", "fused_qkv_attention_bwd", "fused_mlp", "fused_mlp_bwd",
                 "fused_mlp_bwd_acc", "flash_attention", "flash_attention_bwd")
VQA_WORDS = ("yes no two three red blue white black dog cat man woman table left right "
             "tennis pizza frisbee kitchen grass water snow one four green").split()


def albef_model(task: str, dtype):
    """ALBEF at the published fine-tuning widths (ViT-B/16 at 384, a 6-layer
    BERT text tower, 6 cross-attention layers, 768 -> 256 projections, queue
    65,536, temperature 0.07, momentum 0.995; VQA: the 6-layer answer
    decoder) on the CPU in fp32, ``dtype`` the compute dtype; weights drawn
    from a seed as BERT and ViT draw theirs (normal 0.02, zero biases, unit
    LayerNorms)."""
    from multimodal_tpu_torch.examples.albef.model import (
        ALBEFDecoder, ALBEFModelForRetrieval, ALBEFModelForVQA)
    from multimodal_tpu_torch.models.albef.image_encoder import ALBEFVisionEncoder
    from multimodal_tpu_torch.models.albef.model import ALBEFModel, ALBEFModelWithSimilarity
    from multimodal_tpu_torch.models.albef.multimodal_encoder import ALBEFMultimodalEncoder
    from multimodal_tpu_torch.modules.encoders.bert_text_encoder import bert_text_encoder

    w = ALBEF_WIDTHS
    d, heads, mlp = w["hidden"], w["heads"], w["mlp"]
    torch.manual_seed(0)
    albef = ALBEFModel(
        ALBEFVisionEncoder(image_size=ALBEF_IMAGE, patch_size=ALBEF_PATCH,
                           num_hidden_layers=w["vit_layers"], num_attention_heads=heads,
                           hidden_size=d, mlp_dim=mlp, dtype=dtype),
        bert_text_encoder(hidden_size=d, num_hidden_layers=w["text_layers"],
                          num_attention_heads=heads, intermediate_size=mlp, dropout=0.0,
                          vocab_size=w["vocab"], dtype=dtype),
        ALBEFMultimodalEncoder(hidden_size=d, num_hidden_layers=w["mm_layers"],
                               num_attention_heads=heads, intermediate_size=mlp),
        momentum=0.995)
    if task == "vqa":
        model = ALBEFModelForVQA(albef, ALBEFDecoder(
            vocab_size=w["vocab"], hidden_size=d, num_hidden_layers=w["mm_layers"],
            num_attention_heads=heads, intermediate_size=mlp, dtype=dtype))
    else:
        model = ALBEFModelForRetrieval(ALBEFModelWithSimilarity(
            albef, torch.nn.Linear(d, ALBEF_EMBED), torch.nn.Linear(d, ALBEF_EMBED),
            embed_size=ALBEF_EMBED, queue_size=ALBEF_QUEUE, temp=0.07), hidden_size=d)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:
                p.normal_(0.0, 0.02, generator=gen)
            elif p.dim() == 1 and name.endswith("bias"):
                p.zero_()
    return model


def albef_counts(fe, fa) -> dict:
    return {"fused_qkv_attention": fe.fused_qkv_attention.launches,
            "fused_qkv_attention_bwd": fe.fused_qkv_attention_bwd.launches,
            "fused_mlp": fe.fused_mlp.launches, **mlp_bwd_launches(fe),
            "flash_attention": fa.flash_attention_forward.launches,
            "flash_attention_bwd": fa.flash_attention_bwd.launches}


def albef_launches(fe, attn, batch: int, task: str, train: bool = True,
                   answers: Optional[int] = None) -> dict:
    """One step's launches, derived from the dispatch predicates: the ViT
    (12 layers, 577 tokens), the text tower (6, 30 tokens, #1 by
    ``fused_attention_supported``), the multimodal encoder (6; its self and
    cross attention take the flash kernel only from ``FLASH_MIN_SEQ``
    queries) and, for VQA, the decoder (6, 10 answer tokens a row, one row
    an answer: ``answers`` rows in all, ``batch x VQA_ANSWERS`` if None)
    forward with gradients; retrieval adds the momentum forward of the
    vision and text towers (its features need no multimodal pass) and the
    negative pairs' multimodal pass (2 x batch rows); the MLP backward by
    ``fused_mlp_bwd_acc_supported``."""
    w = ALBEF_WIDTHS
    d, heads, mlp, n_mm, n_text = (w["hidden"], w["heads"], w["mlp"], w["mm_layers"],
                                   w["text_layers"])
    flash = lambda sq, sk: sq >= attn.FLASH_MIN_SEQ and sk >= attn.FLASH_MIN_SEQ  # noqa: E731
    vit_flash = not fe.fused_attention_supported(ALBEF_SEQ, d, heads) and flash(ALBEF_SEQ,
                                                                                ALBEF_SEQ)
    text_fused = fe.fused_attention_supported(ALBEF_TEXT, d, heads)
    # (MLP rows, layers, forwards with gradients, forwards without, flash
    # calls a layer)
    mm_flash = int(flash(ALBEF_TEXT, ALBEF_TEXT)) + int(flash(ALBEF_TEXT, ALBEF_SEQ))
    towers = [(batch * ALBEF_SEQ, w["vit_layers"], 1, 0, int(vit_flash)),
              (batch * ALBEF_TEXT, n_text, 1, 0, 0),
              (batch * ALBEF_TEXT, n_mm, 1, 0, mm_flash)]
    if task == "retrieval":
        towers[:2] = [(r, n, 1, 1, f) for r, n, _, _, f in towers[:2]]
        towers.append((2 * batch * ALBEF_TEXT, n_mm, 1, 0, mm_flash))
    else:
        ans = VQA_ANSWER_LEN
        rows = (batch * VQA_ANSWERS if answers is None else answers) * ans
        towers.append((rows, n_mm, 1, 0, int(flash(ans, ans)) + int(flash(ans, ALBEF_TEXT))))
    passes = 2 if task == "retrieval" else 1
    out = {"fused_qkv_attention": n_text * passes if text_fused else 0,
           "fused_qkv_attention_bwd": n_text if text_fused and train else 0,
           "fused_mlp": sum(n * (g + m) for _, n, g, m, _ in towers),
           "flash_attention": sum(n * (g + m) * f for _, n, g, m, f in towers),
           "flash_attention_bwd": sum(n * g * f for _, n, g, m, f in towers) if train else 0,
           "fused_mlp_bwd": 0, "fused_mlp_bwd_acc": 0}
    if train:
        out.update(mlp_bwd_routes(fe, [(r, d, mlp, d, n * g) for r, n, g, _, _ in towers]))
    return out


def albef_expect(label: str, got: dict, want: dict) -> None:
    print(f"albef {label}: launches {json.dumps(got)}", flush=True)
    if got != want:
        fail(f"albef {label}: launches {got}, want {want}")


def write_albef_data(root: str, words) -> dict:
    """The phase's seeded local data under ``root``: 128 training images
    (``mosaic``, 448 x 448 .npy) with two captions each and a json of the
    256 pairs ({image, caption, image_id}); 128 eval images with five
    captions each; a VQA json of 128 questions on the training images, each
    with 10 annotator answers (a few distinct ones, so the weights differ);
    the text transform's WordPiece vocabulary."""
    r = np.random.RandomState(31)
    os.makedirs(os.path.join(root, "images"))

    def caption(lo=6, hi=40):
        return " ".join(r.choice(words, r.randint(lo, hi)))

    train, evals, vqa = [], [], []
    for i in range(ALBEF_TRAIN_IMAGES + ALBEF_EVAL_IMAGES):
        name = f"images/{i:04d}.npy"
        np.save(os.path.join(root, name), mosaic(r, 448, 16))
        if i < ALBEF_TRAIN_IMAGES:
            train += [{"image": name, "caption": caption(), "image_id": f"coco_{i}"}
                      for _ in range(2)]
        else:
            evals.append({"image": name, "caption": [caption()
                                                     for _ in range(ALBEF_EVAL_CAPTIONS)],
                          "image_id": f"coco_{i}"})
    for q in range(VQA_QUESTIONS):
        pool = list(r.choice(VQA_WORDS, r.randint(1, 5), replace=False))
        answers = [" ".join(r.choice(pool, r.randint(1, 3))) for _ in range(10)]
        vqa.append({"dataset": "vqa", "image": train[2 * (q % ALBEF_TRAIN_IMAGES)]["image"],
                    "question": caption(4, 36) + " ?", "answer": answers, "question_id": q})
    paths = {k: os.path.join(root, f"{k}.json") for k in ("train", "eval", "vqa")}
    for k, rows in (("train", train), ("eval", evals), ("vqa", vqa)):
        with open(paths[k], "w") as f:
            json.dump(rows, f)
    paths["vocab"] = os.path.join(root, "vocab.txt")
    with open(paths["vocab"], "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "?"]
                          + sorted(set(words) | set(VQA_WORDS))) + "\n")
    return paths


def albef_feature_cosines(model, ref, features) -> dict:
    """The lowest row cosine of each of ``features(model, device)``'s
    outputs on the card against the fp32 CPU ``ref``'s."""
    with torch.no_grad():
        got, want = features(model, "cuda"), features(ref, "cpu")
    return {k: float(cosine_rows(got[k].float().cpu().numpy(), want[k].float().numpy()).min())
            for k in got}


def albef_grad_cosine(model, ref, step):
    """The card's gradients of ``step(model, device)`` against the fp32 CPU
    ``ref``'s (the same weights), over the parameters that take one: the
    concatenated cosine, the lowest tensor's and both losses."""
    model.zero_grad(set_to_none=True)
    loss = step(model, "cuda")
    loss.backward()
    ref.zero_grad(set_to_none=True)
    ref_loss = step(ref, "cpu")
    ref_loss.backward()
    ref_grads = dict(ref.named_parameters())
    dots = sq_a = sq_b = 0.0
    worst = (2.0, "")
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        a = p.grad.double().cpu().flatten()
        b = ref_grads[name].grad.double().flatten()
        dots += float(a @ b)
        sq_a += float(a @ a)
        sq_b += float(b @ b)
        worst = min(worst, (float(a @ b) / max(float(a.norm() * b.norm()), 1e-300), name))
    model.zero_grad(set_to_none=True)
    return dots / math.sqrt(sq_a * sq_b), worst, float(loss.detach()), float(ref_loss.detach())


def recall_at_k(scores_i2t: torch.Tensor, scores_t2i: torch.Tensor, image_to_text: dict,
                text_to_image: list, ks=(1, 5, 10)) -> dict:
    """Recall@k of the retrieval protocol (the reference's ``itm_eval``): an
    image's rank is its best ground-truth caption's, a caption's its
    image's."""
    order_i = torch.argsort(scores_i2t.float().cpu(), dim=1, descending=True).numpy()
    order_t = torch.argsort(scores_t2i.float().cpu(), dim=1, descending=True).numpy()
    rank_i = np.array([min(int(np.where(order_i[i] == t)[0][0]) for t in gts)
                       for i, gts in image_to_text.items()])
    rank_t = np.array([int(np.where(order_t[j] == img)[0][0])
                       for j, img in enumerate(text_to_image)])
    out = {f"i2t_r{k}": float((rank_i < k).mean()) for k in ks}
    out.update({f"t2i_r{k}": float((rank_t < k).mean()) for k in ks})
    return out


def albef(fe, fa, attn, card):
    """Phase 11: ALBEF retrieval and VQA fine-tuning at ViT-B/16 384 (see
    the module docstring)."""
    phase_t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="albef_")
    try:
        return _albef(fe, fa, attn, card, root, phase_t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _albef(fe, fa, attn, card, root, phase_t0):
    from multimodal_tpu_torch.data.datamodules import _to_image
    from multimodal_tpu_torch.examples.albef.data import (
        RetrievalTrainingDataModule, VQADataModule, retrieval_eval_data)
    from multimodal_tpu_torch.examples.albef.model import (
        albef_retrieval_train_step, retrieval_rerank, vqa_answer_loss)
    from multimodal_tpu_torch.examples.albef.recipes import albef_alpha_schedule, albef_cosine_lr
    from multimodal_tpu_torch.examples.mugen.bert_text_transform import BertTextTransform
    from multimodal_tpu_torch.models.albef.model import ALBEFQueues, init_albef_queues
    from multimodal_tpu_torch.transforms.clip_transform import CLIPImageTransform
    from multimodal_tpu_torch.utils.common import momentum_copy

    def reset():
        fe.reset_launch_counts()
        fa.reset_launch_counts()

    result, paths_out = {}, {}
    words = REAL_WORDS
    paths = write_albef_data(root, words)
    text_t = BertTextTransform(paths["vocab"], max_length=64)
    t0 = time.perf_counter()
    model = albef_model("retrieval", torch.bfloat16).cuda()
    ref = albef_model("retrieval", torch.float32)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"albef: built ALBEFModelForRetrieval (ViT-B/16 at {ALBEF_IMAGE}, {n_params / 1e6:.1f}M "
          f"parameters, fp32, bf16 compute) and its fp32 CPU copy in "
          f"{time.perf_counter() - t0:.1f} s; data written under a temporary directory",
          flush=True)

    # 1. gradients at 2 pairs against fp32 on the CPU, the queue drawn on the
    # CPU from a seed and copied to the card
    r = np.random.RandomState(5)
    image = torch.from_numpy(r.randn(2, ALBEF_IMAGE, ALBEF_IMAGE, 3).astype(np.float32))
    atts = torch.ones(2, ALBEF_TEXT, dtype=torch.long)
    atts[1, 17:] = 0
    text = torch.from_numpy(r.randint(6, ALBEF_WIDTHS["vocab"], (2, ALBEF_TEXT))) * atts
    idx = torch.tensor([0, 1])
    queues_cpu = init_albef_queues(ALBEF_EMBED, ALBEF_QUEUE,
                                   generator=torch.Generator().manual_seed(4), device="cpu")

    def grad_step(m, dev):
        q = queues_cpu if dev == "cpu" else ALBEFQueues(
            *(t.to(dev) for t in (queues_cpu.image_queue, queues_cpu.text_queue,
                                  queues_cpu.idx_queue, queues_cpu.queue_ptr)))
        q = ALBEFQueues(q.image_queue.clone(), q.text_queue.clone(), q.idx_queue.clone(),
                        q.queue_ptr.clone())
        m_m = momentum_copy(m.model_with_similarity, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)  # batch 2: the draw is forced
        return albef_retrieval_train_step(m, m_m, q, image.to(dev), text.to(dev),
                                          atts.to(dev), idx.to(dev), gen, alpha=0.4)

    def features(m, dev):
        sim = m.model_with_similarity
        img, txt, mm, (img_f, txt_f) = sim(image.to(dev), text.to(dev), atts.to(dev))
        return {"image_feat": img_f, "text_feat": txt_f, "multimodal_cls": mm[:, 0]}

    ref.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    feat_cos = albef_feature_cosines(model, ref, features)
    reset()
    cos, (worst_cos, worst_name), loss_card, loss_cpu = albef_grad_cosine(model, ref, grad_step)
    check = albef_counts(fe, fa)
    print(f"albef retrieval: gradient cosine vs fp32 CPU at 2 pairs: {cos:.6f} (bar 0.99); "
          f"lowest tensor {worst_name} {worst_cos:.6f}; loss card {loss_card:.6f} cpu "
          f"{loss_cpu:.6f}; feature cosines {json.dumps(feat_cos)} (bar {ALBEF_COSINE}) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if not cos >= 0.99:
        fail(f"ALBEF retrieval gradient cosine {cos} < 0.99 against fp32 on the CPU")
    if min(feat_cos.values()) < ALBEF_COSINE:
        fail(f"ALBEF feature cosines {feat_cos} below {ALBEF_COSINE}")
    albef_expect("retrieval gradient check", check, albef_launches(fe, attn, 2, "retrieval"))
    result.update(grad_cosine=cos, grad_cosine_lowest=[worst_name, worst_cos],
                  feature_cosines=feat_cos)
    paths_out["albef_grad_check"] = check
    del ref
    torch.cuda.empty_cache()

    # 2. retrieval training from the data layer: 2 warm-up and 5 timed steps
    warmup, steps = 2, 5
    dm = RetrievalTrainingDataModule(
        paths["train"], root, CLIPImageTransform(ALBEF_IMAGE, rng=np.random.RandomState(6)),
        text_t, text_len=ALBEF_TEXT, batch_size=ALBEF_BATCH, seed=0)
    per_epoch = dm.batches_per_epoch()
    model_m = momentum_copy(model.model_with_similarity)
    queues = init_albef_queues(ALBEF_EMBED, ALBEF_QUEUE,
                               generator=torch.Generator().manual_seed(7))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-5, weight_decay=0.02)
    gen = torch.Generator(device="cuda").manual_seed(8)
    stream = dm.train_batches()
    n_step = [0]

    def train_step(batch):
        i = n_step[0]
        for group in opt.param_groups:
            group["lr"] = albef_cosine_lr(i // per_epoch, i % per_epoch)
        alpha = albef_alpha_schedule(i // per_epoch, i % per_epoch, per_epoch)
        b = {k: v.cuda(non_blocking=True) for k, v in batch.items()}
        loss = albef_retrieval_train_step(model, model_m, queues, b["image"], b["text"].long(),
                                          b["text_atts"], b["idx"].long(), gen, alpha=alpha)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        n_step[0] += 1
        return loss.detach()

    losses = [train_step(next(stream)) for _ in range(warmup)]
    # the EMA of one tensor, read around the first timed step
    probe = (f"model_with_similarity.albef_model.text_encoder.encoder.layers."
             f"{ALBEF_WIDTHS['text_layers'] - 1}.feedforward.out.weight")
    p_name = probe.split(".", 1)[1]
    p_before = dict(model.named_parameters())[probe].detach().clone()
    m_before = dict(model_m.named_buffers())[p_name].clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    for s in range(steps):
        losses.append(train_step(next(stream)))
        if s == 0:
            m_after = dict(model_m.named_buffers())[p_name].clone()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    train_counts = albef_counts(fe, fa)
    want = {k: v * steps for k, v in albef_launches(fe, attn, ALBEF_BATCH, "retrieval").items()}
    albef_expect(f"retrieval training ({steps} steps)", train_counts, want)
    losses = [float(x) for x in losses]
    ema = m_before * 0.995 + p_before * (1 - 0.995)
    ema_err = float((m_after - ema).abs().max() / ema.abs().max())
    ptr = int(queues.queue_ptr)
    print(f"albef retrieval: losses {[round(x, 5) for x in losses]}; queue pointer {ptr} after "
          f"{warmup + steps} steps of {ALBEF_BATCH} (want {(warmup + steps) * ALBEF_BATCH}); "
          f"momentum {p_name} against the EMA formula: max relative error {ema_err:.3g}",
          flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"ALBEF retrieval losses {losses}")
    if ptr != (warmup + steps) * ALBEF_BATCH % ALBEF_QUEUE:
        fail(f"ALBEF queue pointer {ptr} after {warmup + steps} steps")
    if not ema_err <= 1e-6:
        fail(f"ALBEF momentum tensor {p_name} off the EMA formula by {ema_err}")
    result.update(items_per_s=ALBEF_BATCH * steps / dt, ms_per_step=dt / steps * 1e3,
                  peak_gib=peak / 2 ** 30, losses=losses, ema_rel_err=ema_err)
    print(f"albef retrieval: {result['items_per_s']:.1f} items/s, {result['ms_per_step']:.1f} ms "
          f"a step at batch {ALBEF_BATCH}, image {ALBEF_IMAGE} (RetrievalTrainingDataModule, "
          f"CLIPImageTransform, prefetched), peak memory {result['peak_gib']:.2f} GiB on {card}",
          flush=True)
    # the stream alone (one thread, nothing else running), then the step on
    # the batches it drew: what the host transform costs, and the step
    # without it
    quiet = RetrievalTrainingDataModule(
        paths["train"], root, CLIPImageTransform(ALBEF_IMAGE, rng=np.random.RandomState(10)),
        text_t, text_len=ALBEF_TEXT, batch_size=ALBEF_BATCH, seed=1, prefetch=0)
    quiet_stream = quiet.train_batches()
    t0 = time.perf_counter()
    drawn = [next(quiet_stream) for _ in range(3)]
    result["stream_ms_per_batch"] = (time.perf_counter() - t0) / 3 * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in drawn:
        train_step(b)
    torch.cuda.synchronize()
    result["drawn_ms_per_step"] = (time.perf_counter() - t0) / 3 * 1e3
    print(f"albef retrieval: the data stream alone {result['stream_ms_per_batch']:.1f} ms a "
          f"batch of {ALBEF_BATCH} (CLIPImageTransform(384) and the tokenizer, one thread); "
          f"the step on batches drawn beforehand {result['drawn_ms_per_step']:.1f} ms",
          flush=True)
    batch = drawn[-1]
    breakdown = profile_step(lambda: train_step(batch), "albef retrieval")
    if isinstance(breakdown, dict):
        result["idle_share"] = 1 - breakdown["total_device_ms"] / breakdown[
            "wall_ms_under_profiler"]
    print(f"albef retrieval: device time of one step by kernel group {json.dumps(breakdown)}; "
          f"idle share {result.get('idle_share', float('nan')):.4f}", flush=True)
    result["profile"] = breakdown
    paths_out["albef_retrieval"] = train_counts
    del opt, stream, dm, batch, drawn, quiet_stream
    torch.cuda.empty_cache()

    # 3. retrieval inference: features, the ITC matrix, the ITM rerank of the
    # top k_test both ways
    data = retrieval_eval_data(paths["eval"], root)
    eval_t = CLIPImageTransform(ALBEF_IMAGE, is_train=False)
    images = torch.stack([eval_t(_to_image(p)) for p in data["images"]])
    ids = text_t(data["texts"])[:, :ALBEF_TEXT]
    ids = torch.nn.functional.pad(ids, (0, ALBEF_TEXT - ids.shape[1]))
    text_atts = ids != 0
    sim_model = model.model_with_similarity
    albef_m = sim_model.albef_model
    model.eval()
    reset()
    t0 = time.perf_counter()
    with torch.inference_mode():
        image_embeds = torch.cat([albef_m.vision_encoder(images[i:i + ALBEF_BATCH].cuda())
                                  for i in range(0, len(images), ALBEF_BATCH)])
        ids_c, atts_c = ids.cuda(), text_atts.cuda()
        text_embeds = torch.cat([albef_m.text_encoder(
            input_ids=ids_c[j:j + 128], attention_mask=atts_c[j:j + 128]).last_hidden_state
            for j in range(0, len(ids), 128)])
        image_feat, text_feat = sim_model.project_features(image_embeds, text_embeds)
        sim_i2t = image_feat @ text_feat.T

        def itm(text_e, att, image_e):
            mm = albef_m.encode_multimodal(text_e, att, image_e)
            return model.itm_scores(mm[:, 0])[:, 1]

        k = ALBEF_K_TEST
        i2t = retrieval_rerank(sim_i2t, lambda i, c: itm(
            text_embeds[c], atts_c[c], image_embeds[i].expand(len(c), -1, -1)), k_test=k)
        t2i = retrieval_rerank(sim_i2t.T, lambda j, c: itm(
            text_embeds[j].expand(len(c), -1, -1), atts_c[j].expand(len(c), -1),
            image_embeds[c]), k_test=k)
        torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    infer_counts = albef_counts(fe, fa)
    n_img, n_txt = len(images), len(ids)
    want = dict.fromkeys(ALBEF_KERNELS, 0)
    w = ALBEF_WIDTHS
    image_calls, text_calls = -(-n_img // ALBEF_BATCH), -(-n_txt // 128)
    vit_flash = not fe.fused_attention_supported(ALBEF_SEQ, w["hidden"], w["heads"])
    want.update(flash_attention=w["vit_layers"] * image_calls * int(vit_flash),
                fused_qkv_attention=w["text_layers"] * text_calls * int(
                    fe.fused_attention_supported(ALBEF_TEXT, w["hidden"], w["heads"])),
                fused_mlp=w["vit_layers"] * image_calls + w["text_layers"] * text_calls
                + w["mm_layers"] * (n_img + n_txt))
    albef_expect("retrieval inference", infer_counts, want)
    recall = recall_at_k(i2t, t2i, data["image_to_text"], data["text_to_image"])
    finite = int(torch.isfinite(i2t).sum()), int(torch.isfinite(t2i).sum())
    print(f"albef retrieval inference: {n_img} images, {n_txt} captions: features, the ITC "
          f"matrix and the ITM rerank of the top {k} both ways in {infer_s:.2f} s "
          f"({n_img + n_txt} rerank calls of {k} pairs); finite scores {finite} (want "
          f"{(n_img * k, n_txt * k)}); recall {json.dumps(recall)} (random weights: chance, "
          f"about 5k/640 image->text, k/128 text->image) on {card}", flush=True)
    if finite != (n_img * k, n_txt * k) or sim_i2t.shape != (n_img, n_txt):
        fail(f"ALBEF rerank scores: finite {finite}, similarity {tuple(sim_i2t.shape)}")
    result.update(rerank_s=infer_s, recall=recall)
    paths_out["albef_inference"] = infer_counts
    del model, model_m, queues, sim_model, albef_m, image_embeds, text_embeds
    torch.cuda.empty_cache()

    # 4. VQA: gradients at 2 questions against fp32 on the CPU, then 1
    # warm-up and 3 timed steps at batch 32 from VQADataModule
    vqa = albef_model("vqa", torch.bfloat16).cuda()
    ref = albef_model("vqa", torch.float32)
    ref.load_state_dict({k: v.float().cpu() for k, v in vqa.state_dict().items()})
    vdm = VQADataModule(paths["vqa"], root, root,
                        CLIPImageTransform(ALBEF_IMAGE, rng=np.random.RandomState(9)), text_t,
                        max_answers=VQA_ANSWERS, question_len=ALBEF_TEXT,
                        answer_len=VQA_ANSWER_LEN, batch_size=ALBEF_BATCH, seed=0)
    vstream = vdm.train_batches()
    first = next(vstream)
    small = {k: v[:2] for k, v in first.items()}

    def vqa_step(m, dev, b=small):
        counts = b["answer_counts"]  # stays on the host: the rows to decode
        b = {k: v.to(dev) for k, v in b.items() if k != "answer_counts"}
        return vqa_answer_loss(m, b["image"], b["question"].long(), b["question_atts"],
                               b["answers"].long(), b["answer_atts"], b["answer_weights"],
                               counts)

    t0 = time.perf_counter()
    reset()
    vcos, (vworst_cos, vworst_name), vloss_card, vloss_cpu = albef_grad_cosine(vqa, ref,
                                                                               vqa_step)
    vcheck = albef_counts(fe, fa)
    print(f"albef vqa: gradient cosine vs fp32 CPU at 2 questions "
          f"({small['answer_counts'].tolist()} answers): {vcos:.6f} (bar 0.99); lowest tensor {vworst_name} {vworst_cos:.6f}; loss "
          f"card {vloss_card:.6f} cpu {vloss_cpu:.6f} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    if not vcos >= 0.99:
        fail(f"ALBEF VQA gradient cosine {vcos} < 0.99 against fp32 on the CPU")
    albef_expect("vqa gradient check", vcheck, albef_launches(
        fe, attn, 2, "vqa", answers=int(small["answer_counts"].sum())))
    del ref
    vopt = torch.optim.AdamW(vqa.parameters(), lr=2e-5, weight_decay=0.02)

    answer_rows = []  # the answers each timed step decodes

    def vqa_train(b, i):
        answer_rows.append(int(b["answer_counts"].sum()))
        for group in vopt.param_groups:
            group["lr"] = albef_cosine_lr(0, i, lr=2e-5)
        loss = vqa_step(vqa, "cuda", b)
        loss.backward()
        vopt.step()
        vopt.zero_grad(set_to_none=True)
        return loss.detach()

    vsteps = 3
    vlosses = [vqa_train(first, 0)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    answer_rows.clear()
    reset()
    t0 = time.perf_counter()
    vlosses += [vqa_train(next(vstream), i + 1) for i in range(vsteps)]
    torch.cuda.synchronize()
    vdt = time.perf_counter() - t0
    vcounts = albef_counts(fe, fa)
    want = {}
    for n in answer_rows:
        for k, v in albef_launches(fe, attn, ALBEF_BATCH, "vqa", answers=n).items():
            want[k] = want.get(k, 0) + v
    albef_expect(f"vqa training ({vsteps} steps)", vcounts, want)
    vlosses = [float(x) for x in vlosses]
    if not all(math.isfinite(x) for x in vlosses):
        fail(f"ALBEF VQA losses {vlosses}")
    result.update(vqa_grad_cosine=vcos, vqa_grad_cosine_lowest=[vworst_name, vworst_cos],
                  vqa_items_per_s=ALBEF_BATCH * vsteps / vdt, vqa_ms_per_step=vdt / vsteps * 1e3,
                  vqa_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, vqa_losses=vlosses)
    result["vqa_answers_per_step"] = answer_rows
    print(f"albef vqa: {result['vqa_items_per_s']:.1f} questions/s, "
          f"{result['vqa_ms_per_step']:.1f} ms a step at batch {ALBEF_BATCH} ({answer_rows} "
          f"answers decoded, of {VQA_ANSWER_LEN} tokens each, at most {VQA_ANSWERS} a "
          f"question), peak memory "
          f"{result['vqa_peak_gib']:.2f} GiB, losses {[round(x, 4) for x in vlosses]} on {card}",
          flush=True)
    paths_out["albef_vqa_grad_check"] = vcheck
    paths_out["albef_vqa"] = vcounts
    del vqa, vopt, vstream, vdm
    torch.cuda.empty_cache()
    result["wall_s"] = time.perf_counter() - phase_t0
    print(f"albef: phase wall time {result['wall_s']:.1f} s", flush=True)
    return paths_out, result


# --------------------------------------------------------------------------
# phases 12 and 13: CoCa ViT-L/14 and BLIP-2 stage 1, training and captioning
# --------------------------------------------------------------------------

COCA_BATCH = 32  # CoCa's 65,536 over 2,048 chips (Yu et al. 2022, arXiv:2205.01917)
COCA_SEQ = 256  # ViT-L/14 at 224 without a CLS token
COCA_TEXT = 77  # the position table: 76 tokens and the CLS token
COCA_VOCAB = 49408
CAPTION_IMAGES = 64
CAPTION_SLOTS = 32
CAPTION_COSINE = 0.999
SOT = 49406
# the depth of coca_vit_l_14 and of BLIP-2's towers; a CPU dry run of a
# phase shrinks these, never the widths
COCA_DEPTH = dict(vision_n_layer=24, text_n_layer=12, fusion_n_layer=12)
BLIP2_BATCH = 128  # the paper's 2,320 for ViT-L over 16 A100s is 145 a GPU (arXiv:2301.12597)
BLIP2_SEQ = 257  # CLIP ViT-L/14 at 224 with its CLS token
BLIP2_TEXT, BLIP2_QUERIES, BLIP2_VOCAB, BLIP2_BOS = 32, 32, 30523, 30522
BLIP2_DEPTH = dict(vit_layers=23, qformer_layers=12)  # BLIP-2 drops the ViT's last layer


def flash_pair(attn, sq, sk):
    return sq >= attn.FLASH_MIN_SEQ and sk >= attn.FLASH_MIN_SEQ


def path_counts(fe, fa, qa) -> dict:
    return {"fused_qkv_attention": fe.fused_qkv_attention.launches,
            "fused_qkv_attention_bwd": fe.fused_qkv_attention_bwd.launches,
            "fused_mlp": fe.fused_mlp.launches, **mlp_bwd_launches(fe),
            "flash_attention": fa.flash_attention_forward.launches,
            "flash_attention_bwd": fa.flash_attention_bwd.launches,
            "flash_attention_bwd_dbias": fa.flash_attention_bwd_dbias.launches,
            "quantized_cache_attention": qa.quantized_cache_attention.launches}


def reset_counts(fe, fa, qa) -> None:
    fe.reset_launch_counts()
    fa.reset_launch_counts()
    qa.reset_launch_counts()


def expect(label: str, got: dict, want: dict) -> None:
    want = {k: want.get(k, 0) for k in got}
    print(f"{label}: launches {json.dumps(got)}", flush=True)
    if got != want:
        fail(f"{label}: launches {got}, want {want}")


def coca_launches(fe, attn, batch: int, train: bool = True) -> dict:
    """One CoCa forward's launches (and its backward's with ``train``),
    derived from the dispatch predicates: the vision tower (256 tokens, #1
    by ``fused_attention_supported``), the pooler (256 queries over 256
    tokens, then 1 query), the text decoder (77 tokens under the dense mask)
    and the fusion layers (76 tokens causal-masked, cross-attending 256);
    the MLP backward by ``fused_mlp_bwd_acc_supported``."""
    nv, nt, nf = (COCA_DEPTH[k] for k in ("vision_n_layer", "text_n_layer", "fusion_n_layer"))
    fused = fe.fused_attention_supported(COCA_SEQ, 1024, 16)
    flash = (nv * int(not fused and flash_pair(attn, COCA_SEQ, COCA_SEQ))
             + nt * flash_pair(attn, COCA_TEXT, COCA_TEXT)
             + nf * (flash_pair(attn, COCA_TEXT - 1, COCA_TEXT - 1)
                     + flash_pair(attn, COCA_TEXT - 1, COCA_SEQ))
             + flash_pair(attn, COCA_SEQ, COCA_SEQ) + flash_pair(attn, 1, COCA_SEQ))
    out = {"fused_qkv_attention": nv * fused, "fused_mlp": nv + nt + nf,
           "flash_attention": flash}
    if train:
        out.update(fused_qkv_attention_bwd=nv * fused, flash_attention_bwd=flash)
        out.update(mlp_bwd_routes(fe, [(batch * COCA_SEQ, 1024, 4096, 1024, nv),
                                       (batch * COCA_TEXT, 768, 3072, 768, nt),
                                       (batch * (COCA_TEXT - 1), 768, 3072, 768, nf)]))
    return out


def coca_batch(rng, b: int):
    """(images (b, 224, 224, 3) fp32 normal, ids (b, 77) CLIP-style with
    seeded lengths and zero padding)."""
    return (torch.from_numpy(rng.standard_normal((b, 224, 224, 3), dtype=np.float32)),
            torch.from_numpy(token_ids(rng, b)))


def cpu_copy(model_fn, module):
    """An fp32 copy of ``module`` on the CPU, built on the meta device by
    ``model_fn(device)`` and filled from ``module``'s state (no second
    random draw)."""
    ref = model_fn("meta").to_empty(device="cpu")
    ref.load_state_dict({k: v.detach().float().cpu() for k, v in module.state_dict().items()})
    return ref.float().eval()


def min_cosines(got: dict, want: dict) -> dict:
    return {k: float(cosine_rows(got[k].float().reshape(-1, got[k].shape[-1]).cpu().numpy(),
                                 want[k].float().reshape(-1, want[k].shape[-1]).numpy()).min())
            for k in got}


def caption_logits(adapter, seq, device, length, geom, conditioning=None, prefix=None):
    """The logits of every position of ``seq`` decoded one token at a time
    over a one-row int8 cache, as the engine's decode ticks run: the cache
    seeded with ``prefix`` rows (BLIP-2's query keys and values) when given,
    the adapter fed ``conditioning`` (CoCa's image tokens) when given."""
    from multimodal_tpu_torch.ops.kv_cache import QuantizedKV, quantized_kv_zeros
    from multimodal_tpu_torch.serving.engine import _kv_rows_like

    n_layer, n_head, head_dim = geom
    shape = (1, n_head, length, head_dim)
    cache = []
    for li in range(n_layer):
        pair = []
        for i in range(2):
            c = quantized_kv_zeros(shape, device)
            if prefix is not None:
                rows = _kv_rows_like(c, 1, prefix[li][i][None].to(device).float(),
                                     prefix[li][i].shape[-2])
                c = QuantizedKV(rows.q, rows.scale)
            pair.append(c)
        cache.append(tuple(pair))
    plen = 0 if prefix is None else prefix[0][0].shape[-2]
    kw = {} if conditioning is None else {"conditioning": conditioning[None].to(device)}
    ar = torch.arange(length, device=device)
    rows = []
    with torch.inference_mode():
        for t, tok in enumerate(seq):
            pos = torch.tensor([plen + t], device=device)
            logits, _ = adapter(torch.tensor([[tok]], device=device), positions=pos[:, None],
                                past_key_values=tuple(cache), cache_index=pos,
                                attention_mask=(ar <= pos)[None, None, None, :],
                                use_cache=True, **kw)
            rows.append(logits[0, 0].float().cpu())
    return torch.stack(rows).double()


def serve_captions(server, submit_all, card, label, fe, fa, qa, layers):
    """Runs ``submit_all(server)``'s requests through the server's engine
    with the counts set to 0 just before: every request must finish at its
    length; #10 and #3 ``layers`` times a decode tick and a prefill call;
    captions/s, decode tokens/s, host and device ms a tick, TTFT p50 and
    one decode call's device time by kernel group."""
    engine = server.engine
    timing = {"prefill": 0.0, "decode": 0.0}

    def timed(name, fn):
        def run(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            timing[name] += time.perf_counter() - t
            return out
        return run

    prefill_name = "_prefill_prefixed" if engine.kv_prefix_len is not None else "_prefill"
    setattr(engine, prefill_name, timed("prefill", getattr(engine, prefill_name)))
    engine._decode = timed("decode", engine._decode)
    reqs = submit_all(server)
    torch.cuda.synchronize()
    reset_counts(fe, fa, qa)
    t0 = time.perf_counter()
    outs = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts(fe, fa, qa)
    calls, ticks = engine.prefill_calls, engine.ticks
    # the prefixed prefill of one token attends the int8 cache through #10
    prefill_qca = layers * calls if engine.kv_prefix_len is not None else 0
    expect(f"{label} serving ({calls} prefill calls, {ticks} decode ticks)", counts,
           {"quantized_cache_attention": layers * ticks + prefill_qca,
            "fused_mlp": layers * (ticks + calls)})
    by_id = {o.request_id: o for o in outs}
    if sorted(by_id) != sorted(r["id"] for r in reqs):
        fail(f"{label}: {len(by_id)} of {len(reqs)} requests finished")
    for r in reqs:
        o = by_id[r["id"]]
        if o.finish_reason != "length" or len(o.tokens) != r["max_new"]:
            fail(f"{label} request {r['id']}: {o.finish_reason}, {len(o.tokens)} of "
                 f"{r['max_new']} tokens")
    decoded = sum(len(o.tokens) - 1 for o in outs)
    ttft = sorted(o.queue_time + o.prefill_time for o in outs)
    result = {"requests": len(outs), "prefill_calls": calls, "decode_ticks": ticks,
              "captions_per_s": len(outs) / wall, "decode_tokens_per_s": decoded / timing["decode"],
              "host_ms_per_tick": timing["decode"] / ticks * 1e3, "prefill_s": timing["prefill"],
              "wall_s": wall, "ttft_p50_s": ttft[len(ttft) // 2], "launches": counts}
    dev = engine.device
    rows = engine.n_slots + 1
    dtok = torch.full((rows,), 5, device=dev)
    dpos = torch.full((rows,), engine.max_len // 2, device=dev)
    dsamp = torch.tensor([[0.0, 0.0, 1.0]] * rows, device=dev)
    groups = profile_step(lambda: engine._decode(dtok, dpos, torch.ones_like(dpos), dsamp, False),
                          f"{label} decode")
    result["decode_profile"] = groups
    if isinstance(groups, dict):
        result["device_ms_per_tick"] = groups["total_device_ms"] / engine.decode_steps
    print(f"{label} serving: " + json.dumps({k: v for k, v in result.items()
                                             if k != "decode_profile"}) + f" on {card}",
          flush=True)
    print(f"{label}: device time of one decode call ({engine.decode_steps} ticks x {rows} rows) "
          f"by kernel group " + json.dumps(groups), flush=True)
    return by_id, result


def coca_phase(fe, fa, qa, attn, card):
    """Phase 12: CoCa ViT-L/14 (see the module docstring)."""
    from multimodal_tpu_torch.models.coca.coca_model import (
        COCA_CONFIGS, coca_for_pretraining, coca_vit)
    from multimodal_tpu_torch.serving.caption_server import CoCaCaptionServer
    from multimodal_tpu_torch.training.trainer import Trainer

    phase_t0 = time.perf_counter()
    cfg = {**COCA_CONFIGS["coca_vit_l_14"], **COCA_DEPTH}
    build = lambda dev: coca_for_pretraining(device=dev, dtype=torch.bfloat16,  # noqa: E731
                                             param_dtype=torch.float32, seed=0, **cfg)
    t0 = time.perf_counter()
    model = build("cuda")
    ref = cpu_copy(lambda dev: coca_for_pretraining(device=dev, dtype=torch.float32, **cfg),
                   model)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"coca: built coca_for_pretraining(coca_vit_l_14) {json.dumps(COCA_DEPTH)}, "
          f"{n_params / 1e6:.1f}M parameters (fp32, bf16 compute) and its fp32 CPU copy in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    result, paths_out = {}, {}
    rng = np.random.default_rng(12)

    # 1. accuracy at batch 4 and gradients at 2 pairs against fp32 on the CPU
    images, texts = coca_batch(rng, 4)

    def outputs(m, dev):
        out = m.model(images.to(dev), texts.to(dev))
        return {"image_embedding": out.image_pooled_output,
                "text_embedding": out.text_pooled_output,
                "captioning_logits": out.multimodal_embeddings}

    t0 = time.perf_counter()
    with torch.no_grad():
        cos = min_cosines(outputs(model, "cuda"), outputs(ref, "cpu"))
    print(f"coca: lowest row cosines vs fp32 CPU at batch 4 {json.dumps(cos)} (bar "
          f"{CAPTION_COSINE}) ({time.perf_counter() - t0:.1f} s)", flush=True)
    if min(cos.values()) < CAPTION_COSINE:
        fail(f"CoCa outputs {cos} below {CAPTION_COSINE} against fp32 on the CPU")

    def step(m, dev):
        out = m(images[:2].to(dev), texts[:2].to(dev))
        return out["contrastive"] + out["captioning"]

    t0 = time.perf_counter()
    model.train()
    reset_counts(fe, fa, qa)
    gcos, (worst_cos, worst_name), loss_card, loss_cpu = albef_grad_cosine(model, ref, step)
    check = path_counts(fe, fa, qa)
    print(f"coca: gradient cosine vs fp32 CPU at 2 pairs: {gcos:.6f} (bar 0.99); lowest tensor "
          f"{worst_name} {worst_cos:.6f}; loss card {loss_card:.6f} cpu {loss_cpu:.6f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if not gcos >= 0.99:
        fail(f"CoCa gradient cosine {gcos} < 0.99 against fp32 on the CPU")
    expect("coca gradient check", check, coca_launches(fe, attn, 2))
    result.update(output_cosines=cos, grad_cosine=gcos, grad_cosine_lowest=[worst_name,
                                                                             worst_cos])
    paths_out["coca_grad_check"] = check

    # 2. training: 2 warm-up and 5 timed steps at batch 32 through the Trainer
    warmup, steps = 2, 5
    batches = [coca_batch(rng, COCA_BATCH) for _ in range(warmup + steps + 1)]
    opt = torch.optim.AdamW(model.parameters(), lr=5e-4, betas=(0.9, 0.999),
                            weight_decay=0.01, fused=True)

    def loss_fn(m, batch):
        out = m(*batch)
        return out["contrastive"] + out["captioning"], {}

    trainer = Trainer(loss_fn, opt, log_interval=100)
    trainer.fit(model, batches[:warmup], warmup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fe, fa, qa)
    t0 = time.perf_counter()
    trainer.fit(model, batches[warmup:warmup + steps], steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = path_counts(fe, fa, qa)
    expect(f"coca training ({steps} steps)", counts,
           {k: v * steps for k, v in coca_launches(fe, attn, COCA_BATCH).items()})
    losses = [r["loss"] for r in trainer.logger.records if "loss" in r]
    if not all(math.isfinite(x) for x in losses):
        fail(f"CoCa losses {losses}")
    result.update(items_per_s=COCA_BATCH * steps / dt, ms_per_step=dt / steps * 1e3,
                  peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, losses=losses)
    print(f"coca: {result['items_per_s']:.1f} items/s, {result['ms_per_step']:.1f} ms a step at "
          f"batch {COCA_BATCH}, peak memory {result['peak_gib']:.2f} GiB, losses "
          f"{[round(x, 4) for x in losses]} on {card}", flush=True)
    breakdown = profile_step(lambda: trainer.fit(model, batches[-1:], 1), "coca train")
    if isinstance(breakdown, dict):
        result["idle_share"] = 1 - breakdown["total_device_ms"] / breakdown[
            "wall_ms_under_profiler"]
    print(f"coca: device time of one step by kernel group {json.dumps(breakdown)}; idle share "
          f"{result.get('idle_share', float('nan')):.4f}", flush=True)
    result["profile"] = breakdown
    paths_out["coca_train"] = counts
    del opt, trainer, batches
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    # 3. captioning: a bf16 copy behind CoCaCaptionServer, an int8 cache
    serve_model = coca_vit(device="meta", dtype=torch.bfloat16, **cfg).to_empty(device="cuda")
    serve_model.load_state_dict(model.model.state_dict())
    serve_model.eval()
    # the CPU reference takes the trained weights too
    ref.load_state_dict({k: v.detach().float().cpu() for k, v in model.state_dict().items()})
    del model
    torch.cuda.empty_cache()
    server = CoCaCaptionServer(serve_model, n_slots=CAPTION_SLOTS, cache_dtype="int8",
                               prefill_batch=8, decode_steps=8)
    srng = np.random.default_rng(13)
    images = torch.from_numpy(srng.standard_normal((CAPTION_IMAGES, 224, 224, 3),
                                                   dtype=np.float32))
    t0 = time.perf_counter()
    cap, _ = server.encode(images)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    max_new = server.adapter.max_positions - 1

    def submit_all(s):
        reqs = []
        for i in range(CAPTION_IMAGES):
            sampled = i % 2 == 1
            s.submit([SOT], image_tokens=cap[i], request_id=i, max_new_tokens=max_new,
                     temperature=1.0 if sampled else 0.0, top_k=50 if sampled else None)
            reqs.append({"id": i, "max_new": max_new})
        return reqs

    layers = COCA_DEPTH["text_n_layer"] + COCA_DEPTH["fusion_n_layer"]
    by_id, serving = serve_captions(server, submit_all, card, "coca", fe, fa, qa, layers)
    serving["encode_s"] = encode_s
    # 2 served captions teacher-forced through the int8 decode path against
    # fp32 on the CPU
    geom = (server.adapter.n_layer, server.adapter.n_head, server.adapter.head_dim)
    ref_adapter = type(server.adapter)(ref.model)
    worst = 1.0
    for i in (0, 1):
        seq = [SOT] + by_id[i].tokens[:15]
        with torch.no_grad():
            ref_cap, _ = ref.model.encode_image(images[i:i + 1])
        a = caption_logits(server.adapter, seq, "cuda", server.adapter.max_positions, geom,
                           conditioning=cap[i])
        b = caption_logits(ref_adapter, seq, "cpu", server.adapter.max_positions, geom,
                           conditioning=ref_cap[0])
        worst = min(worst, float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min()))
    print(f"coca: 2 served captions ({len(seq)} positions each) teacher-forced through the int8 "
          f"cache, lowest logit cosine vs fp32 CPU {worst:.6f} (bar 0.99)", flush=True)
    if worst < 0.99:
        fail(f"CoCa served-caption logits reach cosine {worst} < 0.99 against fp32")
    serving["teacher_forced_cosine"] = worst
    result["serving"] = serving
    paths_out["coca_serve"] = serving.pop("launches")
    del server, serve_model, ref, ref_adapter
    torch.cuda.empty_cache()
    result["wall_s"] = time.perf_counter() - phase_t0
    print(f"coca: phase wall time {result['wall_s']:.1f} s", flush=True)
    return paths_out, result


def blip2_modules(dtype, device, seed: int = 0):
    """BLIP-2 stage 1 at the published widths: the port's ViT-L/14 image
    tower (23 layers, 257 tokens, frozen), the Q-Former (``QformerForCLM``,
    12 layers, 768 wide, cross-attention every 2nd layer to 1024, vocab
    30,523) and ``Blip2Phase1Loss``; ``dtype`` the compute dtype, fp32
    weights drawn from ``seed`` (normal 0.02, zero biases, unit LayerNorms)
    on the CPU, then moved to ``device``."""
    from multimodal_tpu_torch.models.blip2.blip2 import BLIP2
    from multimodal_tpu_torch.models.blip2.qformer_model import QformerForCLM
    from multimodal_tpu_torch.modules.encoders.vision_transformer import vision_transformer
    from multimodal_tpu_torch.modules.losses.blip2_losses import Blip2Phase1Loss

    w = BLIP2_DEPTH
    with torch.device("meta" if device == "meta" else "cpu"):
        model = BLIP2(
            QformerForCLM(num_hidden_layers=w["qformer_layers"], dim_q=768, dim_feedforward=3072,
                          num_heads=12, max_position_embeddings=512, vocab_size=BLIP2_VOCAB,
                          query_length=BLIP2_QUERIES, dim_kv=1024, dtype=dtype),
            vision_transformer(patch_size=14, hidden_dim=1024, dim_feedforward=4096,
                               n_layer=w["vit_layers"], n_head=16, image_size=224,
                               include_cls_embed=True, dtype=dtype),
            dim_q=768, image_encoder_embedding_dim=1024, embedding_dim=256,
            num_query_token=BLIP2_QUERIES, decoder_bos_token_id=BLIP2_BOS, dtype=dtype)
        loss = Blip2Phase1Loss(dim_q=768)
    model.vision_encoder.requires_grad_(False)
    if device == "meta":
        return model, loss
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in (model, loss):
            for name, p in m.named_parameters():
                if p.dim() >= 2:
                    p.normal_(0.0, 0.02, generator=gen)
                elif name.endswith("bias"):
                    p.zero_()
    return model.to(device), loss.to(device)


def blip2_launches(fe, attn, batch: int, train: bool = True) -> dict:
    """One stage-1 step's launches, derived from the dispatch predicates:
    the frozen tower (257 tokens: past #1's 256, so #6; no backward), the
    Q-Former's query pass (32 queries, cross-attention in every 2nd layer),
    text pass (32 tokens, the padding bias), captioning pass (32 text
    queries over 32 cached query rows and the text) and the ITM pass over
    the 3x batch ([32 queries; 32 text]); each pass's MLPs (the query
    branch, the text branch) and, with ``train``, their backward by
    ``fused_mlp_bwd_acc_supported``."""
    nv, nq = BLIP2_DEPTH["vit_layers"], BLIP2_DEPTH["qformer_layers"]
    ca = len(range(0, nq, 2))
    q, t = BLIP2_QUERIES, BLIP2_TEXT
    tower_fused = fe.fused_attention_supported(BLIP2_SEQ, 1024, 16)
    tower_flash = nv * int(not tower_fused and flash_pair(attn, BLIP2_SEQ, BLIP2_SEQ))
    qf_flash = (nq * flash_pair(attn, q, q) + ca * flash_pair(attn, q, BLIP2_SEQ)
                + nq * flash_pair(attn, t, t) + nq * flash_pair(attn, t, q + t)
                + nq * flash_pair(attn, q + t, q + t) + ca * flash_pair(attn, q, BLIP2_SEQ))
    # (rows, layers) of each Q-Former MLP call: query pass, text pass,
    # captioning pass, ITM's query and text branches
    mlps = [(batch * q, nq), (batch * t, nq), (batch * t, nq), (3 * batch * q, nq),
            (3 * batch * t, nq)]
    out = {"fused_qkv_attention": nv * tower_fused, "fused_mlp": nv + sum(n for _, n in mlps),
           "flash_attention": tower_flash + qf_flash}
    if train:
        out["flash_attention_bwd"] = qf_flash
        out.update(mlp_bwd_routes(fe, [(r, 768, 3072, 768, n) for r, n in mlps]))
    return out


def blip2_batch(rng, b: int):
    """(images, ids, attention mask): ids of ``BLIP2_TEXT`` tokens, [CLS]
    first, seeded lengths in [4, 32], zero padding."""
    lengths = rng.integers(4, BLIP2_TEXT + 1, size=b)
    atts = (np.arange(BLIP2_TEXT)[None, :] < lengths[:, None]).astype(np.int64)
    ids = rng.integers(1000, BLIP2_VOCAB - 1, size=(b, BLIP2_TEXT)) * atts
    ids[:, 0] = 101
    return (torch.from_numpy(rng.standard_normal((b, 224, 224, 3), dtype=np.float32)),
            torch.from_numpy(ids), torch.from_numpy(atts))


class Blip2Stage1(torch.nn.Module):
    """BLIP-2 and its stage-1 loss module as one module for the Trainer and
    the gradient check; ``forward`` is the total loss."""

    def __init__(self, model, loss, generator=None):
        super().__init__()
        self.model, self.loss = model, loss
        self.generator = generator

    def forward(self, image, ids, atts):
        from multimodal_tpu_torch.modules.losses.blip2_losses import blip2_phase1_loss

        out = self.model(image, ids, atts)
        return blip2_phase1_loss(self.loss, self.model, out, ids, atts, self.generator,
                                 decoder_bos_token_id=BLIP2_BOS, vocab_size=BLIP2_VOCAB)


def blip2_phase(fe, fa, qa, attn, card):
    """Phase 13: BLIP-2 stage 1 (see the module docstring)."""
    from multimodal_tpu_torch.modules.losses import blip2_losses
    from multimodal_tpu_torch.serving.blip2_caption_server import Blip2CaptionServer
    from multimodal_tpu_torch.training.trainer import Trainer

    phase_t0 = time.perf_counter()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(14)
    stage = Blip2Stage1(*blip2_modules(torch.bfloat16, "cuda"), generator=gen)
    ref = cpu_copy(lambda dev: Blip2Stage1(*blip2_modules(torch.float32, dev)), stage)
    n_params = sum(p.numel() for p in stage.parameters())
    n_trained = sum(p.numel() for p in stage.parameters() if p.requires_grad)
    print(f"blip2: built BLIP-2 stage 1 {json.dumps(BLIP2_DEPTH)}, {n_params / 1e6:.1f}M "
          f"parameters ({n_trained / 1e6:.1f}M trained; fp32, bf16 compute) and its fp32 CPU "
          f"copy in {time.perf_counter() - t0:.1f} s", flush=True)
    result, paths_out = {}, {}
    rng = np.random.default_rng(15)

    # 1. accuracy at batch 4 and gradients at 2 pairs against fp32 on the CPU
    image, ids, atts = blip2_batch(rng, 4)

    def outputs(s, dev):
        out = s.model(image.to(dev), ids.to(dev), atts.to(dev))
        return {"image_features": out.image_features, "text_features": out.text_features,
                "prediction_scores": out.prediction_scores}

    t0 = time.perf_counter()
    with torch.no_grad():
        cos = min_cosines(outputs(stage, "cuda"), outputs(ref, "cpu"))
    print(f"blip2: lowest row cosines vs fp32 CPU at batch 4 {json.dumps(cos)} (bar "
          f"{CAPTION_COSINE}) ({time.perf_counter() - t0:.1f} s)", flush=True)
    if min(cos.values()) < CAPTION_COSINE:
        fail(f"BLIP-2 outputs {cos} below {CAPTION_COSINE} against fp32 on the CPU")

    # the card's hard negatives replayed in the CPU step
    drawn = []
    draw = blip2_losses.hard_negative_indices

    def record(*a, **k):
        drawn.append(draw(*a, **k))
        return drawn[-1]

    def step(s, dev):
        if dev == "cuda":
            blip2_losses.hard_negative_indices = record
        else:
            blip2_losses.hard_negative_indices = lambda *a, **k: tuple(
                x.cpu() for x in drawn[-1])
        try:
            return s(image[:2].to(dev), ids[:2].to(dev), atts[:2].to(dev)).total_loss
        finally:
            blip2_losses.hard_negative_indices = draw

    t0 = time.perf_counter()
    stage.train()
    reset_counts(fe, fa, qa)
    gcos, (worst_cos, worst_name), loss_card, loss_cpu = albef_grad_cosine(stage, ref, step)
    check = path_counts(fe, fa, qa)
    tower_grads = [p.grad for p in stage.model.vision_encoder.parameters() if p.grad is not None]
    print(f"blip2: gradient cosine vs fp32 CPU at 2 pairs (the card's negatives "
          f"{[x.tolist() for x in drawn[-1]]} on both): {gcos:.6f} (bar 0.99); lowest tensor "
          f"{worst_name} {worst_cos:.6f}; loss card {loss_card:.6f} cpu {loss_cpu:.6f}; tower "
          f"tensors with a gradient {len(tower_grads)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    if not gcos >= 0.99:
        fail(f"BLIP-2 gradient cosine {gcos} < 0.99 against fp32 on the CPU")
    if tower_grads:
        fail("a gradient reached BLIP-2's frozen image tower")
    expect("blip2 gradient check", check, blip2_launches(fe, attn, 2))
    result.update(output_cosines=cos, grad_cosine=gcos, grad_cosine_lowest=[worst_name,
                                                                             worst_cos])
    paths_out["blip2_grad_check"] = check

    # 2. training: 2 warm-up and 5 timed steps at batch 128 through the Trainer
    warmup, steps = 2, 5
    batches = [blip2_batch(rng, BLIP2_BATCH) for _ in range(warmup + steps + 1)]
    trained = [p for p in stage.parameters() if p.requires_grad]
    opt = torch.optim.AdamW(trained, lr=1e-4, betas=(0.9, 0.98), weight_decay=0.05, fused=True)
    trainer = Trainer(lambda s, b: (s(*b).total_loss, {}), opt, log_interval=100)
    trainer.fit(stage, batches[:warmup], warmup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fe, fa, qa)
    t0 = time.perf_counter()
    trainer.fit(stage, batches[warmup:warmup + steps], steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = path_counts(fe, fa, qa)
    expect(f"blip2 training ({steps} steps)", counts,
           {k: v * steps for k, v in blip2_launches(fe, attn, BLIP2_BATCH).items()})
    losses = [r["loss"] for r in trainer.logger.records if "loss" in r]
    if not all(math.isfinite(x) for x in losses):
        fail(f"BLIP-2 losses {losses}")
    result.update(items_per_s=BLIP2_BATCH * steps / dt, ms_per_step=dt / steps * 1e3,
                  peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, losses=losses)
    print(f"blip2: {result['items_per_s']:.1f} items/s, {result['ms_per_step']:.1f} ms a step at "
          f"batch {BLIP2_BATCH}, peak memory {result['peak_gib']:.2f} GiB, losses "
          f"{[round(x, 4) for x in losses]} on {card}", flush=True)
    breakdown = profile_step(lambda: trainer.fit(stage, batches[-1:], 1), "blip2 train")
    if isinstance(breakdown, dict):
        result["idle_share"] = 1 - breakdown["total_device_ms"] / breakdown[
            "wall_ms_under_profiler"]
    print(f"blip2: device time of one step by kernel group {json.dumps(breakdown)}; idle share "
          f"{result.get('idle_share', float('nan')):.4f}", flush=True)
    result["profile"] = breakdown
    paths_out["blip2_train"] = counts
    del opt, trainer, batches
    stage.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    # 3. captioning: a bf16 copy behind Blip2CaptionServer, an int8 cache
    serve_model, _ = blip2_modules(torch.bfloat16, "meta")
    serve_model = serve_model.to(torch.bfloat16).to_empty(device="cuda")
    for m in serve_model.modules():
        if isinstance(m, torch.nn.LayerNorm):
            m.float()
    serve_model.load_state_dict(stage.model.state_dict())
    serve_model.eval()
    ref.load_state_dict({k: v.detach().float().cpu() for k, v in stage.state_dict().items()})
    del stage
    torch.cuda.empty_cache()
    server = Blip2CaptionServer(serve_model, n_slots=CAPTION_SLOTS, max_text_len=BLIP2_TEXT,
                                cache_dtype="int8", prefill_batch=8, decode_steps=8)
    srng = np.random.default_rng(16)
    images = torch.from_numpy(srng.standard_normal((CAPTION_IMAGES, 224, 224, 3),
                                                   dtype=np.float32))
    t0 = time.perf_counter()
    kvs, _ = server.prime(images)
    torch.cuda.synchronize()
    prime_s = time.perf_counter() - t0
    max_new = BLIP2_TEXT - 1

    def submit_all(s):
        reqs = []
        for i in range(CAPTION_IMAGES):
            sampled = i % 2 == 1
            s.submit([BLIP2_BOS], kv_prefix=kvs[i], request_id=i, max_new_tokens=max_new,
                     temperature=1.0 if sampled else 0.0, top_k=50 if sampled else None)
            reqs.append({"id": i, "max_new": max_new})
        return reqs

    by_id, serving = serve_captions(server, submit_all, card, "blip2", fe, fa, qa,
                                    BLIP2_DEPTH["qformer_layers"])
    serving["prime_s"] = prime_s
    geom = (server.adapter.n_layer, server.adapter.n_head, server.adapter.head_dim)
    ref_server = Blip2CaptionServer(ref.model, n_slots=1, max_text_len=BLIP2_TEXT, device="cpu")
    worst = 1.0
    for i in (0, 1):
        seq = [BLIP2_BOS] + by_id[i].tokens[:15]
        ref_kv, _ = ref_server.prime(images[i:i + 1])
        a = caption_logits(server.adapter, seq, "cuda", server.engine.max_len, geom,
                           prefix=kvs[i])
        b = caption_logits(ref_server.adapter, seq, "cpu", server.engine.max_len, geom,
                           prefix=ref_kv[0])
        worst = min(worst, float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min()))
    print(f"blip2: 2 served captions ({len(seq)} positions each) teacher-forced through the "
          f"int8 cache over the primed query rows, lowest logit cosine vs fp32 CPU "
          f"{worst:.6f} (bar 0.99)", flush=True)
    if worst < 0.99:
        fail(f"BLIP-2 served-caption logits reach cosine {worst} < 0.99 against fp32")
    serving["teacher_forced_cosine"] = worst
    result["serving"] = serving
    paths_out["blip2_serve"] = serving.pop("launches")
    del server, serve_model, ref, ref_server
    torch.cuda.empty_cache()
    result["wall_s"] = time.perf_counter() - phase_t0
    print(f"blip2: phase wall time {result['wall_s']:.1f} s", flush=True)
    return paths_out, result


# --------------------------------------------------------------------------
# slice 10 (BASELINE.json's fifth config): MUGEN retrieval, MDETR grounding
# --------------------------------------------------------------------------

MDETR_LONG, MDETR_SHORT = 1066, 800  # 800 x 1066 and 1066 x 800 images pad to 1066 x 1066
MDETR_GRID = 34  # ResNet-101's stride-32 grid of a 1066-pixel side
MUGEN_SIDE, MUGEN_SIZE = 256, 224  # the clips' frames and the transform's output
MDETR_TEXT = 64  # MDETRDataModule's text_len
MDETR_SEQ = MDETR_GRID * MDETR_GRID + MDETR_TEXT  # 1,220 encoder tokens
MDETR_QUERIES = 100
MUGEN_TEXT = 32


def mdetr_key_mask(b: int, sk: int, gen) -> torch.Tensor:
    """(B, Sk) bool, True = a real key, as MDETR's encoder and cross-
    attention see them: the 34 x 34 grid of 800 x 1066 (even rows) and
    1066 x 800 (odd rows) images padded to 1066 x 1066 (the padding by the
    half-pixel nearest resize), then text tokens of seeded lengths."""
    from multimodal_tpu_torch.models.mdetr.image_encoder import resize_mask_nearest

    pad = torch.ones(b, MDETR_LONG, MDETR_LONG, dtype=torch.bool, device="cuda")
    pad[0::2, :MDETR_SHORT, :] = False
    pad[1::2, :, :MDETR_SHORT] = False
    img = ~resize_mask_nearest(pad, (MDETR_GRID, MDETR_GRID)).reshape(b, -1)
    n_text = sk - img.shape[1]
    text = torch.arange(n_text, device="cuda")[None] < _key_lengths(b, n_text, gen, 8)[:, None]
    return torch.cat([img, text], dim=1)


# Slice 10's kernel cases, on a generator of their own (``slice10_gen``):
# #6 at head width 32 (the `wgmma` kernel) at MDETR's encoder self-
# attention (1,220 tokens, key padding as segment ids), decoder self-
# attention (100 queries) and cross-attention (100 queries over the 1,220
# tokens, key padding); #1 at MUGEN's text tower at evaluation (16 x 32) and
# MDETR's RoBERTa (8 x 64), with their key biases; #3 with ReLU at MDETR's
# encoder (8 x 1,220 rows) and decoder (8 x 100) MLPs, and with exact GELU
# at the text towers' 512 rows.
MDETR_FLASH_CASES = [
    ("mdetr_encoder_1220", 8, 8, MDETR_SEQ, MDETR_SEQ, 32, False, {"segments": "key_padding"}),
    ("mdetr_decoder_self_100", 8, 8, MDETR_QUERIES, MDETR_QUERIES, 32, False, {}),
    ("mdetr_cross_100x1220", 8, 8, MDETR_QUERIES, MDETR_SEQ, 32, False,
     {"segments": "key_padding"}),
]
SLICE10_ATTENTION_CASES = [
    ("mugen_text", 16, MUGEN_TEXT, 768, 12, False, True),
    ("mdetr_roberta", 8, MDETR_TEXT, 768, 12, False, True),
]
SLICE10_MLP_CASES = [
    ("mdetr_encoder", 8 * MDETR_SEQ, 256, 2048, 256, "relu"),
    ("mdetr_decoder", 8 * MDETR_QUERIES, 256, 2048, 256, "relu"),
    ("mugen_text", 16 * MUGEN_TEXT, 768, 3072, 768, "gelu_exact"),
]


def slice10_gen(dtype: torch.dtype) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(17 if dtype == torch.bfloat16 else 18)


def check_slice10_kernels(fe, fa, dtypes=(torch.bfloat16, torch.float32), timing=True):
    """#6, #1 and #3 at slice 10's shapes in each dtype, each against its
    plain version and timed against its library call, beside its bound."""
    rows = []
    for dtype in dtypes:
        gen = slice10_gen(dtype)
        for name, b, h, sq, sk, d, causal, kw in MDETR_FLASH_CASES:
            rows.append(flash_case(fa, name, b, h, sq, sk, d, causal, dtype, gen, timing=timing,
                                   **kw))
        for name, b, s, d, h, causal, kb in SLICE10_ATTENTION_CASES:
            rows.append(attention_case(fe, name, b, s, d, h, causal, dtype, kb, gen,
                                       timing=timing))
        for shape in SLICE10_MLP_CASES:
            rows.append(mlp_case(fe, *shape, dtype, gen, timing=timing))
        torch.cuda.empty_cache()
    for row in rows:
        print("kernel_check " + json.dumps(row), flush=True)
    return rows


# Slice 11's #3 cases, on a generator of their own (``slice11_gen``): MUGEN
# text-to-video's GPT MLP (768 -> 3,072 -> 768, quick-GELU) at a serving tick
# (8 slots and the trash row: 9 rows), a sampler step at batch 8 (8 rows)
# and the prefill bucket (8 prompts x 128 text tokens: 1,024 rows), and
# VideoGPT's (576 -> 2,304 -> 576) at its teacher-forced forward (two
# 8 x 32 x 32 latents: 16,384 rows).
T2V_TEXT = 128  # MUGEN's text length, the serving prompt
T2V_SLOTS = 8
SLICE11_MLP_CASES = [
    ("mugen_t2v_tick", T2V_SLOTS + 1, 768, 3072, 768, "quick_gelu"),
    ("mugen_t2v_step", 8, 768, 3072, 768, "quick_gelu"),
    ("mugen_t2v_prefill", 8 * T2V_TEXT, 768, 3072, 768, "quick_gelu"),
    ("video_gpt_forward", 2 * 8 * 32 * 32, 576, 2304, 576, "quick_gelu"),
]


# MDETR VQA fine-tuning's kernels, forward and backward (the model runs
# deterministic, as JAX's loss runs it) at its batch of 4, on generators of
# their own (``vqa_gen``): #6 and the flash backward (#7 + #8; head width
# 32, the backward on `mma.sync`) at the encoder's self-attention and the
# cross-attention, key padding as segment ids, and at the decoder's self-
# attention; #1 and #2 at RoBERTa's (4, 64, 3 x 768) with its key bias; #3
# and #4 at the encoder's (4 x 1,220 rows) and decoder's (4 x 100) MLPs, 256
# -> 2048 -> 256 ReLU, and RoBERTa's 256 rows, 768 -> 3,072 -> 768 exact
# GELU (all under ``_ACC_MIN_ROWS``: #4, not #5).
VQA_BATCH = 4
VQA_FLASH_CASES = [
    ("vqa_encoder_1220", VQA_BATCH, 8, MDETR_SEQ, MDETR_SEQ, 32, False,
     {"segments": "key_padding"}),
    ("vqa_cross_100x1220", VQA_BATCH, 8, MDETR_QUERIES, MDETR_SEQ, 32, False,
     {"segments": "key_padding"}),
    ("vqa_decoder_self_100", VQA_BATCH, 8, MDETR_QUERIES, MDETR_QUERIES, 32, False, {}),
]
VQA_ATTENTION_CASES = [("vqa_roberta", VQA_BATCH, MDETR_TEXT, 768, 12, False, True)]
VQA_MLP_CASES = [
    ("vqa_encoder", VQA_BATCH * MDETR_SEQ, 256, 2048, 256, "relu"),
    ("vqa_decoder", VQA_BATCH * MDETR_QUERIES, 256, 2048, 256, "relu"),
    ("vqa_roberta", VQA_BATCH * MDETR_TEXT, 768, 3072, 768, "gelu_exact"),
]


def slice11_gen(dtype: torch.dtype) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(19 if dtype == torch.bfloat16 else 20)


def vqa_gen(dtype: torch.dtype) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(21 if dtype == torch.bfloat16 else 22)


def vqa_flash_cases(fa, dtype, gen, timing=True):
    """#6 and the flash backward at ``VQA_FLASH_CASES`` in ``dtype`` (the
    backward timed in bf16 only)."""
    rows = []
    for name, b, h, sq, sk, d, causal, kw in VQA_FLASH_CASES:
        rows.append(flash_case(fa, name, b, h, sq, sk, d, causal, dtype, gen, timing=timing,
                               **kw))
        torch.cuda.empty_cache()
        rows.append(flash_bwd_case(fa, name, b, h, sq, sk, d, causal, dtype, gen,
                                   timing=timing and dtype == torch.bfloat16, **kw))
        torch.cuda.empty_cache()
    return rows


def check_vqa_flash_kernels(fa, dtypes=(torch.bfloat16, torch.float32), timing=True):
    """``vqa_flash_cases`` in each dtype on its own generator, printed: the
    check a planted fault in the flash kernels runs besides theirs."""
    rows = [r for dtype in dtypes for r in vqa_flash_cases(fa, dtype, vqa_gen(dtype), timing)]
    for row in rows:
        print("kernel_check " + json.dumps(row), flush=True)
    return rows


def check_slice11_kernels(fe, fa, dtypes=(torch.bfloat16, torch.float32), timing=True):
    """#3 at slice 11's text-to-video shapes, and MDETR VQA's kernels forward
    and backward at its shapes, in each dtype: each against its plain
    version (#6's and the flash backward's fp32 cases against float64),
    relaunched into NaN-filled outputs, and timed against its library call
    beside its bound."""
    rows = []
    for dtype in dtypes:
        gen = slice11_gen(dtype)
        for shape in SLICE11_MLP_CASES:
            rows.append(mlp_case(fe, *shape, dtype, gen, timing=timing))
        gen = vqa_gen(dtype)
        rows += vqa_flash_cases(fa, dtype, gen, timing)
        for name, b, s, d, h, causal, kb in VQA_ATTENTION_CASES:
            rows.append(attention_case(fe, name, b, s, d, h, causal, dtype, kb, gen,
                                       timing=timing))
            rows.append(attention_bwd_case(fe, name, b, s, d, h, causal, dtype, kb, gen,
                                           timing=timing))
        for shape in VQA_MLP_CASES:
            rows.append(mlp_case(fe, *shape, dtype, gen, timing=timing))
            rows.append(mlp_bwd_case(fe, *shape, dtype, gen, timing=timing))
        torch.cuda.empty_cache()
    for row in rows:
        print("kernel_check " + json.dumps(row), flush=True)
    return rows


def text_tower_launches(fe, seq: int, layers: int, dropout: bool) -> dict:
    """A BERT-style tower's launches, derived from the dispatch predicates:
    #1 a layer where ``fused_attention_supported`` holds and no dropout is
    on (its key-padding mask on the key-bias lane), #3 a layer where
    ``fused_mlp_available`` holds and no dropout is on. Training runs the
    towers at dropout 0.1: no kernel."""
    if dropout:
        return {}
    return {"fused_qkv_attention": layers * fe.fused_attention_supported(seq, 768, 12),
            "fused_mlp": layers * fe.fused_mlp_available(768, 3072, 768)}


def mdetr_launches(fe, attn, train: bool = False) -> dict:
    """One MDETR forward's launches (none in training, at dropout 0.1):
    RoBERTa's 12 layers by ``text_tower_launches``; the encoder's 6 layers a
    self-attention over 1,220 tokens (#6 by ``FLASH_MIN_SEQ``) and an MLP
    (#3 by ``fused_mlp_available(256, 2048, 256)``); the decoder's 6 layers
    a self-attention over 100 queries, a cross-attention over 1,220 tokens
    and an MLP. The box head's three-layer MLP takes no kernel."""
    if train:
        return {}
    out = text_tower_launches(fe, MDETR_TEXT, 12, False)
    mlp = fe.fused_mlp_available(256, 2048, 256)
    out["fused_mlp"] += 12 * mlp
    out["flash_attention"] = (6 * flash_pair(attn, MDETR_SEQ, MDETR_SEQ)
                              + 6 * (flash_pair(attn, MDETR_QUERIES, MDETR_QUERIES)
                                     + flash_pair(attn, MDETR_QUERIES, MDETR_SEQ)))
    return out


def write_mugen_data(root: str, rng) -> dict:
    """A MUGEN release in the data module's layout: ``{split}.json`` and
    ``{id}.npy`` clips of 96 uint8 frames at 256 x 256 (the transform
    resizes them to 224), 32 train and 64 val clips with two annotations
    each, and a WordPiece vocab of the annotations' words."""
    words = ("mugen jumps runs over a the gap coin collects climbs ladder kills slime monster "
             "walks left right and then from platform gem lands falls onto rope").split()
    paths = {"path": root, "frames_dir": root, "vocab_path": os.path.join(root, "vocab.txt")}
    with open(paths["vocab_path"], "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + sorted(set(words))))
    for split, n in (("train", 32), ("val", 64)):
        data = []
        for i in range(n):
            vid = f"{split}_{i}"
            np.save(os.path.join(root, f"{vid}.npy"),
                    rng.integers(0, 256, (96, MUGEN_SIDE, MUGEN_SIDE, 3), dtype=np.uint8))
            texts = [" ".join(rng.choice(words, rng.integers(6, 24))) for _ in range(2)]
            data.append({"video": {"id": vid, "num_frames": 96},
                         "annotations": [{"text": t} for t in texts]})
        with open(os.path.join(root, f"{split}.json"), "w") as f:
            json.dump({"metadata": {"seed": 0}, "data": data}, f)
    return paths


def mugen_phase(fe, fa, qa, attn, card):
    """Phase 14: MUGEN text-to-video retrieval (see the module docstring)."""
    from multimodal_tpu_torch.examples.mugen import retrieval_train as rt
    from multimodal_tpu_torch.training.retrieval_eval import retrieval_recall_at_k
    from multimodal_tpu_torch.transforms.video_transform import VideoTransform

    phase_t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="mugen_")
    try:
        return _mugen(fe, fa, qa, attn, card, rt, retrieval_recall_at_k,
                      VideoTransform(resize_shape=(MUGEN_SIZE, MUGEN_SIZE)), root, phase_t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _mugen(fe, fa, qa, attn, card, rt, recall_at, transform, root, phase_t0):
    t0 = time.perf_counter()
    paths = write_mugen_data(root, np.random.default_rng(14))
    print(f"mugen: wrote 96 clips of 96 frames at {MUGEN_SIDE} x {MUGEN_SIDE} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cfg = rt.build_config(None, [f"data.{k}={v}" for k, v in paths.items()] + [
        "model.bf16=true", "train.log_interval=100"], defaults=rt.DEFAULTS)
    d = cfg["data"]
    trainer, model = rt.build_trainer_and_state(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"mugen: VideoCLIPForRetrieval (S3D + DistilBERT 6 x 768), {n_params / 1e6:.1f}M "
          f"parameters (fp32, bf16 compute); batch {d['batch_size']}, "
          f"{d['sequence_length']} frames every {d['sample_every_n_frames']}, text "
          f"{d['text_len']}, AdamW lr {cfg['train']['lr']} wd {cfg['train']['weight_decay']}",
          flush=True)
    result, paths_out = {}, {}

    def on_card(batches):
        """The data module's batches with their video resized on the card
        (``VideoTransform``: 256 -> 224, normalized)."""
        for b in batches:
            yield {"video": transform(b["video"].cuda(non_blocking=True)),
                   "text": b["text"].cuda(non_blocking=True)}

    stream = on_card(rt.build_datamodule(cfg, "train").train_batches())
    warmup, steps = 2, 5
    trainer.fit(model, stream, warmup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fe, fa, qa)
    t0 = time.perf_counter()
    trainer.fit(model, stream, steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = path_counts(fe, fa, qa)
    expect(f"mugen training ({steps} steps)", counts,
                   text_tower_launches(fe, d["text_len"], 6, True))
    losses = [r["loss"] for r in trainer.logger.records if "loss" in r]
    if not all(math.isfinite(x) for x in losses):
        fail(f"MUGEN losses {losses}")
    result.update(items_per_s=d["batch_size"] * steps / dt, ms_per_step=dt / steps * 1e3,
                  peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, losses=losses)
    print(f"mugen: {result['items_per_s']:.2f} items/s, {result['ms_per_step']:.1f} ms a step "
          f"(the data module's stream and the transform included), peak memory "
          f"{result['peak_gib']:.2f} GiB, losses {[round(x, 4) for x in losses]} on {card}",
          flush=True)
    paths_out["mugen_train"] = counts
    batch = next(stream)
    breakdown = profile_step(lambda: trainer.fit(model, iter([batch]), 1), "mugen train")
    if isinstance(breakdown, dict):
        result["idle_share"] = 1 - breakdown["total_device_ms"] / breakdown[
            "wall_ms_under_profiler"]
    result["profile"] = breakdown
    print(f"mugen: device time of one step (a drawn batch) by kernel group "
          f"{json.dumps(breakdown)}; idle share {result.get('idle_share', float('nan')):.4f}",
          flush=True)

    # recall over the 64-clip validation split, the towers in eval mode
    model.eval()
    reset_counts(fe, fa, qa)
    t0 = time.perf_counter()
    v_emb, t_emb, n_batches = [], [], 0
    with torch.no_grad():
        for b in on_card(rt.build_datamodule(cfg, "val").eval_batches()):
            v_emb.append(model.encode_video(b["video"]).float())
            t_emb.append(model.encode_text(b["text"]).float())
            n_batches += 1
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    counts = path_counts(fe, fa, qa)
    want = text_tower_launches(fe, d["text_len"], 6, False)
    expect("mugen recall eval", counts, {k: v * n_batches for k, v in want.items()})
    recalls = recall_at(torch.cat(v_emb), torch.cat(t_emb))
    result["recall"] = {f"{dd}_recall_{k}": recalls[f"{s}_recall_{k}"]
                        for dd, s in (("v2t", "a2b"), ("t2v", "b2a")) for k in (1, 5, 10)}
    result["eval_s"] = eval_s
    print(f"mugen: recall over {len(torch.cat(v_emb))} val clips (random weights: chance is "
          f"k / 64) {json.dumps(result['recall'])} in {eval_s:.1f} s", flush=True)
    paths_out["mugen_eval"] = counts

    # the bf16 towers against an fp32 copy of the same weights on the card
    ref = rt.build_model({**cfg, "model": {**cfg["model"], "bf16": False}})
    ref.load_state_dict(model.state_dict())
    ref.eval()
    b = next(on_card(rt.build_datamodule(cfg, "val").eval_batches()))
    with torch.no_grad():
        got = {"video": model.encode_video(b["video"][:4]), "text": model.encode_text(b["text"])}
        want = {"video": ref.encode_video(b["video"][:4]), "text": ref.encode_text(b["text"])}
    cos = {k: float(cosine_rows(got[k].float().cpu().numpy(), want[k].float().cpu().numpy())
                    .min()) for k in got}
    print(f"mugen: lowest row cosines of the bf16 towers vs fp32 on the card {json.dumps(cos)} "
          f"(bar {SLICE10_COSINE})", flush=True)
    if min(cos.values()) < SLICE10_COSINE:
        fail(f"MUGEN embeddings {cos} below {SLICE10_COSINE} against fp32")
    result["output_cosines"] = cos
    del ref, model, trainer
    torch.cuda.empty_cache()
    result["wall_s"] = time.perf_counter() - phase_t0
    print(f"mugen: phase wall time {result['wall_s']:.1f} s", flush=True)
    return paths_out, result


SLICE10_COSINE = 0.99
FLICKR_WORDS = ("a man woman child dog ball red blue shirt hat on in with near the park street "
                "grass runs throws holds sits stands looks at two small big white black").split()
FLICKR_TYPES = ("people", "clothing", "animals", "other", "scene", "bodyparts")


def write_flickr_data(root: str, n: int, rng) -> list:
    """``n`` seeded images (uint8, 800 x 1066 and 1066 x 800 in turn: the
    shape of Flickr30k's 375 x 500 photos at MDETR's evaluation scale,
    shorter side 800) and one caption each with 1-4 boxed phrases, in
    Flickr30k Entities' layout (``test.txt``, ``Sentences/<id>.txt``,
    ``Annotations/<id>.xml``) and as the samples ``MDETRDataModule`` takes
    (boxes cxcywh in [0, 1], ``tokens_positive`` char spans). Returns the
    samples, with their phrases' char spans for the eval."""
    os.makedirs(os.path.join(root, "Sentences"))
    os.makedirs(os.path.join(root, "Annotations"))
    samples = []
    for i in range(n):
        h, w = (MDETR_SHORT, MDETR_LONG) if i % 2 == 0 else (MDETR_LONG, MDETR_SHORT)
        img_id = str(1000 + i)
        path = os.path.join(root, f"{img_id}.npy")
        np.save(path, rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        words, tagged, spans, boxes, objs = [], [], [], [], []
        n_phrases = int(rng.integers(1, 5))
        for p in range(n_phrases):
            filler = list(rng.choice(FLICKR_WORDS, rng.integers(1, 6)))
            phrase = list(rng.choice(FLICKR_WORDS, rng.integers(1, 4)))
            words += filler
            tagged += filler
            start = len(" ".join(words)) + (1 if words else 0)
            words += phrase
            spans.append([(start, start + len(" ".join(phrase)))])
            tagged += [f"[/EN#{p + 1}/{FLICKR_TYPES[p % len(FLICKR_TYPES)]}"] + phrase
            tagged[-1] += "]"
            x0, y0 = rng.uniform(0, 0.6, 2)
            bw, bh = rng.uniform(0.1, 0.4, 2)
            boxes.append([x0 + bw / 2, y0 + bh / 2, bw, bh])
            xyxy = [int(x0 * w), int(y0 * h), int((x0 + bw) * w), int((y0 + bh) * h)]
            objs.append(f"<object><name>{p + 1}</name><bndbox><xmin>{xyxy[0]}</xmin><ymin>"
                        f"{xyxy[1]}</ymin><xmax>{xyxy[2]}</xmax><ymax>{xyxy[3]}</ymax></bndbox>"
                        f"</object>")
        extra = list(rng.choice(FLICKR_WORDS, min(int(rng.integers(0, 40)),
                                                  MDETR_TEXT - len(words))))
        words += extra
        tagged += extra
        with open(os.path.join(root, "Sentences", f"{img_id}.txt"), "w") as f:
            f.write(" ".join(tagged) + "\n")
        with open(os.path.join(root, "Annotations", f"{img_id}.xml"), "w") as f:
            f.write(f"<annotation><size><width>{w}</width><height>{h}</height><depth>3</depth>"
                    f"</size>{''.join(objs)}</annotation>")
        samples.append({"image": path, "text": " ".join(words), "boxes": boxes,
                        "tokens_positive": spans, "image_id": img_id, "orig_size": (h, w)})
    with open(os.path.join(root, "test.txt"), "w") as f:
        f.write("\n".join(s["image_id"] for s in samples) + "\n")
    return samples


def grounding_inputs(batch, device="cuda"):
    """The model's inputs from an ``MDETRDataModule`` batch: RoBERTa's pad
    id (1) on the padded text positions, and the masks True = padded."""
    text_real = batch["text_attention_mask"].to(device)
    text = torch.where(text_real, batch["text"].to(device), 1)
    return (batch["images"].to(device), batch["image_mask"].to(device), text, ~text_real)


def mdetr_phase(fe, fa, qa, attn, card):
    """Phase 15: MDETR phrase grounding (see the module docstring)."""
    root = tempfile.mkdtemp(prefix="flickr_")
    try:
        return _mdetr(fe, fa, qa, attn, card, root, time.perf_counter())
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _mdetr(fe, fa, qa, attn, card, root, phase_t0):
    from multimodal_tpu_torch.examples.mdetr import optimizer as mopt
    from multimodal_tpu_torch.examples.mdetr.data import (
        MDETRDataModule, create_positive_map, whitespace_tokenize_with_offsets)
    from multimodal_tpu_torch.examples.mdetr.eval import evaluate_phrase_grounding
    from multimodal_tpu_torch.examples.mdetr.flickr_eval import Flickr30kEntitiesRecallEvaluator
    from multimodal_tpu_torch.models.mdetr.model import mdetr_for_phrase_grounding
    from multimodal_tpu_torch.modules.losses import mdetr as mloss

    t0 = time.perf_counter()
    samples = write_flickr_data(root, 32, np.random.default_rng(15))
    print(f"mdetr: wrote 32 images ({MDETR_SHORT} x {MDETR_LONG} and {MDETR_LONG} x "
          f"{MDETR_SHORT}) and their Flickr30k Entities files in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    model = mdetr_for_phrase_grounding(dtype=torch.bfloat16, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"mdetr: mdetr_for_phrase_grounding (ResNet-101, RoBERTa-base, d_model 256, 8 heads "
          f"of 32, 6 + 6 layers, 100 queries), {n_params / 1e6:.1f}M parameters (fp32, bf16 "
          f"compute), built in {time.perf_counter() - t0:.1f} s", flush=True)
    result, paths_out = {}, {}

    # 1. grounding inference at batch 8 over the 32 images, Flickr30k recall
    def eval_batches():
        dm = MDETRDataModule(samples, text_len=MDETR_TEXT, batch_size=8, shuffle=False,
                             drop_last=False)
        for start, batch in zip(range(0, len(samples), 8), dm.eval_batches()):
            chunk = samples[start:start + 8]
            images, image_mask, text, text_mask = grounding_inputs(batch)
            pms = []
            for s in chunk:
                _, offsets = whitespace_tokenize_with_offsets(s["text"])
                pms.append(create_positive_map(offsets, s["tokens_positive"]))
            yield {"images": images, "image_mask": image_mask, "text": text,
                   "text_mask": text_mask,
                   "orig_sizes": torch.tensor([s["orig_size"] for s in chunk]),
                   "positive_map_eval": torch.from_numpy(np.concatenate(pms)),
                   "phrases_per_sample": [len(s["tokens_positive"]) for s in chunk],
                   "image_ids": [s["image_id"] for s in chunk], "sentence_ids": [0] * len(chunk)}

    evaluator = Flickr30kEntitiesRecallEvaluator(root, subset="test")
    batches = list(eval_batches())
    with torch.no_grad():  # warm-up: cuDNN's plans, the first launches
        model(*(batches[0][k] for k in ("images", "image_mask", "text", "text_mask")))
    torch.cuda.synchronize()
    reset_counts(fe, fa, qa)
    t0 = time.perf_counter()
    report = evaluate_phrase_grounding(model, batches, evaluator, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = path_counts(fe, fa, qa)
    expect("mdetr grounding eval (4 forwards)", counts,
                   {k: 4 * v for k, v in mdetr_launches(fe, attn).items()})
    result.update(images_per_s=len(samples) / dt, eval_ms_per_batch=dt / len(batches) * 1e3,
                  recall={str(k): v for k, v in report.items()})
    print(f"mdetr: grounding eval {result['images_per_s']:.2f} images/s, "
          f"{result['eval_ms_per_batch']:.1f} ms a batch of 8 (post-processing and the "
          f"evaluator included); Flickr30k recall (random weights) "
          f"{json.dumps({k: round(v.get('all', 0.0), 4) for k, v in report.items()})}", flush=True)
    paths_out["mdetr_eval"] = counts
    b0 = batches[0]
    args = tuple(b0[k] for k in ("images", "image_mask", "text", "text_mask"))
    with torch.no_grad():
        breakdown = profile_step(lambda: model(*args), "mdetr forward")
    result["eval_profile"] = breakdown
    print(f"mdetr: device time of one forward at batch 8 by kernel group "
          f"{json.dumps(breakdown)}", flush=True)

    # 2. the bf16 model against an fp32 copy of its weights on the card
    ref = mdetr_for_phrase_grounding(dtype=torch.float32, seed=1)
    ref.load_state_dict(model.state_dict())
    ref.eval()
    small = tuple(a[:2] for a in args)
    with torch.no_grad():
        outs = [m(*small) for m in (model, ref)]
    pick = lambda o: {"pred_logits": o.model_output.pred_logits,  # noqa: E731
                      "pred_boxes": o.model_output.pred_boxes,
                      **o.contrastive_embeddings}
    got, want = pick(outs[0]), pick(outs[1])
    cos = {k: float(cosine_rows(got[k].float().reshape(-1, got[k].shape[-1]).cpu().numpy(),
                                want[k].float().reshape(-1, want[k].shape[-1]).cpu().numpy()
                                ).min()) for k in got}
    print(f"mdetr: lowest row cosines of the bf16 model vs fp32 on the card at 2 images "
          f"{json.dumps(cos)} (bar {SLICE10_COSINE})", flush=True)
    if min(cos.values()) < SLICE10_COSINE:
        fail(f"MDETR outputs {cos} below {SLICE10_COSINE} against fp32")
    result["output_cosines"] = cos
    del ref, outs
    torch.cuda.empty_cache()

    # 3. fine-tuning: 3 steps after 1 at batch 4, mdetr_loss and the MDETR
    # optimizer (lr 1e-4, backbone 1e-5, text encoder 5e-5, wd 1e-4)
    schedules = mopt.mdetr_lr_schedules("linear_with_warmup", 1e-4, 1e-5, 5e-5,
                                        num_training_steps=100, steps_per_epoch=8, lr_drop=35,
                                        epochs=20)
    opt, sched = mopt.build_mdetr_optimizer(model, schedules)
    weights = mloss.build_weight_dict()
    dm = MDETRDataModule(samples, text_len=MDETR_TEXT, batch_size=4, shuffle=True, seed=0)
    train_batches = [b for _, b in zip(range(5), dm.train_batches())]

    def train_step(batch):
        opt.zero_grad(set_to_none=True)
        out = model(*grounding_inputs(batch), deterministic=False)
        pm = batch["positive_map"].cuda()
        loss = mloss.mdetr_loss(
            out.model_output.pred_logits, out.model_output.pred_boxes, pm,
            batch["target_boxes"].cuda(), batch["valid"].cuda(),
            out.contrastive_embeddings["query_embeddings"],
            out.contrastive_embeddings["token_embeddings"], pm[..., :MDETR_TEXT])
        total = loss.total(weights)
        total.backward()
        opt.step()
        sched.step()
        return total.detach(), out.model_output

    model.train()
    train_step(train_batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fe, fa, qa)
    t0 = time.perf_counter()
    steps = [train_step(b) for b in train_batches[1:4]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = path_counts(fe, fa, qa)
    expect("mdetr fine-tuning (3 steps)", counts, mdetr_launches(fe, attn, train=True))
    losses = [float(loss) for loss, _ in steps]
    if not all(math.isfinite(x) for x in losses):
        fail(f"MDETR losses {losses}")
    # the matcher alone on the host: the last step's cost, already on the
    # card, to the host and through scipy
    last, batch = steps[-1][1], train_batches[3]
    cost = mloss.hungarian_cost_matrix(last.pred_logits.detach(), last.pred_boxes.detach().float(),
                                       batch["positive_map"].cuda(),
                                       batch["target_boxes"].cuda())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mloss.hungarian_matcher(cost, batch["valid"].cuda())
    matcher_ms = (time.perf_counter() - t1) * 1e3
    result.update(train_items_per_s=4 * 3 / dt, ms_per_step=dt / 3 * 1e3,
                  peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, losses=losses,
                  matcher_host_ms=matcher_ms, lrs={g["name"]: g["lr"] for g in opt.param_groups})
    print(f"mdetr: fine-tuning {result['train_items_per_s']:.2f} images/s, "
          f"{result['ms_per_step']:.1f} ms a step at batch 4, peak memory "
          f"{result['peak_gib']:.2f} GiB, the Hungarian matcher {matcher_ms:.3f} ms on the host "
          f"(a (4, 100, 16) cost), losses {[round(x, 4) for x in losses]}, rates "
          f"{json.dumps(result['lrs'])} on {card}", flush=True)
    paths_out["mdetr_train"] = counts
    del steps, last
    breakdown = profile_step(lambda: train_step(train_batches[4]), "mdetr train")
    if isinstance(breakdown, dict):
        result["idle_share"] = 1 - breakdown["total_device_ms"] / breakdown[
            "wall_ms_under_profiler"]
    result["profile"] = breakdown
    print(f"mdetr: device time of one fine-tuning step by kernel group "
          f"{json.dumps(breakdown)}; idle share {result.get('idle_share', float('nan')):.4f}",
          flush=True)
    del model, opt
    torch.cuda.empty_cache()
    result["wall_s"] = time.perf_counter() - phase_t0
    print(f"mdetr: phase wall time {result['wall_s']:.1f} s", flush=True)
    return paths_out, result


# --------------------------------------------------------------------------
# phases 16 and 17: MUGEN text-to-video generation, MDETR VQA fine-tuning
# --------------------------------------------------------------------------

T2V_PROMPTS = 16
T2V_SAMPLE_BATCH = 8
T2V_GREEDY_STEPS = 16  # the steps the fp32 server and sampler must agree on
T2V_TEACHER_FORCED = 4  # requests whose served tokens are teacher-forced
T2V_ROUND_TRIP = 8  # clips through the VQ-VAE
T2V_COSINE = 0.99
# text_video_gpt's and video_gpt's defaults: MUGEN's model and VideoGPT at
# their published widths (a CPU dry run shrinks them)
T2V_WIDTHS: dict = {}
VIDEO_GPT_WIDTHS: dict = {}
T2V_WORDS = ("mugen jumps runs over a the gap coin collects climbs ladder kills slime monster "
             "walks left right and then from platform gem lands falls onto rope bee snail "
             "to up down").split()


def t2v_prompts(rng, n: int) -> list:
    """``n`` seeded MUGEN-style captions of 6 to 60 words (the longest run
    past the 128-token text length and are cut)."""
    return [" ".join(rng.choice(T2V_WORDS, rng.integers(6, 61))) for _ in range(n)]


def randomize_to_logit(gpt, seed: int) -> None:
    """``to_logit`` is zero-initialised (its logits tie): fan-in normal
    weights from ``seed`` instead, so greedy decoding is unique."""
    w = gpt.to_logit.weight
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        w.copy_((torch.randn(w.shape, generator=gen) * w.shape[1] ** -0.5).to(w.device))


def t2v_phase(fe, fa, qa, attn, card):
    """Phase 16: MUGEN text-to-video generation (see the module docstring)."""
    from multimodal_tpu_torch.examples.mugen.text_video_gpt import text_video_gpt
    from multimodal_tpu_torch.models.video_gpt.model import video_gpt
    from multimodal_tpu_torch.serving.video_gpt_server import VideoGPTServer
    from multimodal_tpu_torch.utils.generate import GenerationUtil

    phase_t0 = time.perf_counter()
    t0 = time.perf_counter()
    gpt = text_video_gpt(bpe_path=str(MERGES), dtype=torch.bfloat16, seed=0, **T2V_WIDTHS)
    randomize_to_logit(gpt, 19)
    dec = gpt.mm_decoder.decoder
    layers, d_model = dec.num_layers, gpt.d_model
    text_len, latent = gpt.in_tokenizer.context_len, math.prod(gpt.latent_shape)
    vq = gpt.out_tokenizer
    side = T2V_WIDTHS.get("resolution", 256)
    video_shape = (T2V_WIDTHS.get("video_seq_len", 32), side, side)
    mlp = int(fe.fused_mlp_available(d_model, 4 * d_model, d_model))
    n_params = sum(p.numel() for p in gpt.parameters())
    print(f"t2v: text_video_gpt ({text_len} BPE tokens over {gpt.num_in_tokens} ids, latent "
          f"{gpt.latent_shape} = {latent} tokens over {gpt.num_out_tokens} codes, d_model "
          f"{d_model}, {dec.n_head} heads, {layers} layers; MUGEN's VQ-VAE to {video_shape}), "
          f"{n_params / 1e6:.1f}M parameters (fp32, bf16 compute), to_logit random, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    result, paths_out = {}, {}

    rng = np.random.default_rng(19)
    prompts = t2v_prompts(rng, T2V_PROMPTS)
    t0 = time.perf_counter()
    ids = gpt.in_tokenizer.tokenize_host(prompts)
    result["tokenize_ms"] = (time.perf_counter() - t0) * 1e3
    if ids.shape != (T2V_PROMPTS, text_len):
        fail(f"t2v: tokenized prompts {ids.shape}")
    print(f"t2v: {T2V_PROMPTS} prompts tokenized with clip_merges.bpe to {ids.shape} in "
          f"{result['tokenize_ms']:.1f} ms", flush=True)

    # 1. serving: 16 requests on 8 slots, the whole latent volume each, even
    # ids greedy and odd ids sampled at temperature 1
    server = VideoGPTServer(gpt, in_seq_len=text_len, n_slots=T2V_SLOTS)
    engine = server.engine
    server.submit(ids[0].tolist(), request_id="warm-up",
                  max_new_tokens=min(engine.decode_steps + 1, latent))
    server.run()
    timing = {"prefill": 0.0, "decode": 0.0}

    def timed(name, fn):
        def run(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            timing[name] += time.perf_counter() - t
            return out
        return run

    prefill_fn, decode_fn = engine._prefill_prefixed, engine._decode
    engine._prefill_prefixed = timed("prefill", prefill_fn)
    engine._decode = timed("decode", decode_fn)
    for i, row in enumerate(ids):
        server.submit(row.tolist(), request_id=i, temperature=0.0 if i % 2 == 0 else 1.0)
    calls0, ticks0 = engine.prefill_calls, engine.ticks
    torch.cuda.synchronize()
    reset_counts(fe, fa, qa)
    t0 = time.perf_counter()
    outs = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts(fe, fa, qa)
    engine._prefill_prefixed, engine._decode = prefill_fn, decode_fn
    calls, ticks = engine.prefill_calls - calls0, engine.ticks - ticks0
    expect(f"t2v serving ({calls} prefill calls, {ticks} decode ticks)", counts,
           {"fused_mlp": layers * (ticks + calls) * mlp})
    paths_out["mugen_t2v_serve"] = counts
    by_id = {o.request_id: o for o in outs}
    for i in range(T2V_PROMPTS):
        o = by_id.get(i)
        if o is None or o.finish_reason != "length" or len(o.tokens) != latent \
                or not all(0 <= t < gpt.num_out_tokens for t in o.tokens):
            fail(f"t2v request {i}: {None if o is None else (o.finish_reason, len(o.tokens))}")
    ttft = sorted(o.queue_time + o.prefill_time for o in outs)
    serving = {"requests": len(outs), "prefill_calls": calls, "decode_ticks": ticks,
               "videos_per_s": len(outs) / wall,
               "decode_tokens_per_s": sum(len(o.tokens) - 1 for o in outs) / timing["decode"],
               "host_ms_per_tick": timing["decode"] / ticks * 1e3,
               "prefill_ms_per_call": timing["prefill"] / calls * 1e3, "wall_s": wall,
               "ttft_p50_s": ttft[len(ttft) // 2], "launches": counts}

    # #3's launches in one prefill call and one decode call alone
    dev = engine.device
    pfx_kvs, plen = engine._prefixes["sos"]
    n = engine.prefill_batch
    ptok = torch.from_numpy(np.repeat(ids[:1], n, axis=0)).to(dev)
    trash = torch.full((n,), engine.n_slots, device=dev)
    plens = torch.full((n,), text_len, device=dev)
    psamp = torch.tensor([[0.0, 0.0, 1.0]] * n, device=dev)
    rows = engine.n_slots + 1
    dtok = torch.full((rows,), gpt.num_in_tokens + 5, device=dev)
    dpos = torch.full((rows,), engine.max_len // 2, device=dev)
    dsamp = torch.tensor([[0.0, 0.0, 1.0]] * rows, device=dev)
    reset_counts(fe, fa, qa)
    engine._prefill_prefixed(pfx_kvs, plen, ptok, trash, plens, psamp)
    torch.cuda.synchronize()
    per_prefill = path_counts(fe, fa, qa)
    expect("t2v: one prefill call", per_prefill, {"fused_mlp": layers * mlp})
    reset_counts(fe, fa, qa)
    engine._decode(dtok, dpos, torch.ones_like(dpos), dsamp, False)
    torch.cuda.synchronize()
    per_call = path_counts(fe, fa, qa)
    expect(f"t2v: one decode call ({engine.decode_steps} ticks)", per_call,
           {"fused_mlp": layers * engine.decode_steps * mlp})
    serving["fused_mlp_per_prefill"] = per_prefill["fused_mlp"]
    serving["fused_mlp_per_tick"] = per_call["fused_mlp"] / engine.decode_steps
    groups = profile_step(lambda: engine._decode(dtok, dpos, torch.ones_like(dpos), dsamp, False),
                          "t2v decode")
    serving["decode_profile"] = groups
    if isinstance(groups, dict):
        serving["device_ms_per_tick"] = groups["total_device_ms"] / engine.decode_steps
        serving["decode_idle_share"] = 1 - groups["total_device_ms"] / groups[
            "wall_ms_under_profiler"]
    result["serving"] = serving
    print("t2v serving: " + json.dumps({k: v for k, v in serving.items()
                                        if k != "decode_profile"}) + f" on {card}", flush=True)
    print(f"t2v: #3 launches {serving['fused_mlp_per_prefill']} a prefill call and "
          f"{serving['fused_mlp_per_tick']:g} a tick; device time of one decode call "
          f"({engine.decode_steps} ticks x {rows} rows) by kernel group {json.dumps(groups)}",
          flush=True)

    # 2. the served tokens to pixels
    tokens = np.asarray([by_id[i].tokens for i in range(T2V_PROMPTS)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    videos = server.decode_videos(tokens)
    torch.cuda.synchronize()
    result["decode_videos_s"] = time.perf_counter() - t0
    if tuple(videos.shape) != (T2V_PROMPTS,) + video_shape + (3,) \
            or not bool(torch.isfinite(videos).all()):
        fail(f"t2v: decoded videos {tuple(videos.shape)}, finite "
             f"{bool(torch.isfinite(videos).all())}")
    print(f"t2v: decode_videos {tuple(videos.shape)} {videos.dtype}, finite, in "
          f"{result['decode_videos_s']:.2f} s", flush=True)
    del videos
    torch.cuda.empty_cache()

    # 3. GenerationUtil at batch 8 on the same prompts, greedy
    x = torch.from_numpy(ids[:T2V_SAMPLE_BATCH]).cuda()
    torch.cuda.synchronize()
    reset_counts(fe, fa, qa)
    t0 = time.perf_counter()
    out = GenerationUtil(gpt).sample(x, max_seq_len=latent, top_k=1)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    counts = path_counts(fe, fa, qa)
    expect(f"t2v GenerationUtil (prime + {latent} steps)", counts,
           {"fused_mlp": layers * (1 + latent) * mlp})
    paths_out["mugen_t2v_sample"] = counts
    if tuple(out.decoded.shape) != (T2V_SAMPLE_BATCH,) + video_shape + (3,) \
            or not bool(torch.isfinite(out.decoded).all()):
        fail(f"t2v: sampler's videos {tuple(out.decoded.shape)}")
    result["sampler"] = {"batch": T2V_SAMPLE_BATCH, "s": sample_s,
                         "tokens_per_s": T2V_SAMPLE_BATCH * latent / sample_s,
                         "ms_per_step": sample_s / latent * 1e3}
    print(f"t2v: GenerationUtil.sample at batch {T2V_SAMPLE_BATCH}, {latent} greedy steps and "
          f"the VQ decoding in {sample_s:.2f} s ({result['sampler']['ms_per_step']:.2f} ms a "
          f"step, the decoding included) on {card}", flush=True)
    del out
    torch.cuda.empty_cache()

    # 4. fp32 on the card: the server's greedy tokens against GenerationUtil's
    ref = text_video_gpt(bpe_path=str(MERGES), dtype=torch.float32, seed=1, **T2V_WIDTHS)
    ref.load_state_dict(gpt.state_dict())
    steps = min(T2V_GREEDY_STEPS, latent)
    srv32 = VideoGPTServer(ref, in_seq_len=text_len, n_slots=T2V_SLOTS, max_new_tokens=steps,
                           cache_dtype=torch.float32)
    for i in range(T2V_SAMPLE_BATCH):
        srv32.submit(ids[i].tolist(), request_id=i)
    served32 = {o.request_id: o.tokens for o in srv32.run()}
    want32 = GenerationUtil(ref).sample(x, max_seq_len=latent, top_k=1).tokens.cpu().numpy()
    agree = [served32[i] == want32[i, :steps].tolist() for i in range(T2V_SAMPLE_BATCH)]
    print(f"t2v: fp32 greedy, server vs GenerationUtil over the first {steps} steps: "
          f"{sum(agree)} of {T2V_SAMPLE_BATCH} requests equal", flush=True)
    if not all(agree):
        fail(f"t2v: fp32 server and sampler disagree on requests "
             f"{[i for i, a in enumerate(agree) if not a]}")
    result["fp32_greedy_equal"] = sum(agree)
    del srv32

    # 5. the served tokens teacher-forced: bf16 logits against fp32
    n = T2V_TEACHER_FORCED
    in_t = torch.from_numpy(ids[:n]).cuda()
    out_t = torch.from_numpy(tokens[:n]).cuda()
    num_in = gpt.num_in_tokens
    with torch.no_grad():
        got = [m(in_tokens=in_t, out_tokens=out_t, causal=True, right_shift=True)
               .logits[:, text_len - 1:-1, num_in:] for m in (gpt, ref)]
    cos = float(cosine_rows(got[0].reshape(-1, got[0].shape[-1]).cpu().numpy(),
                            got[1].reshape(-1, got[1].shape[-1]).cpu().numpy()).min())
    print(f"t2v: teacher-forced logits of {n} served videos, bf16 vs fp32 on the card: lowest "
          f"row cosine {cos:.6f} (bar {T2V_COSINE})", flush=True)
    if cos < T2V_COSINE:
        fail(f"t2v: teacher-forced logits cosine {cos} below {T2V_COSINE}")
    result["teacher_forced_cosine"] = cos
    del got

    # 6. a VQ-VAE round trip of 8 clips, bf16, and the codes against fp32
    clips = torch.rand((T2V_ROUND_TRIP,) + video_shape + (3,), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(21)) - 0.5
    reset_counts(fe, fa, qa)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codes = vq.encode(clips)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rec = vq.decode(codes)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        codes32 = ref.out_tokenizer.encode(clips)
    expect("t2v VQ-VAE round trip", path_counts(fe, fa, qa), {})
    if tuple(codes.shape) != (T2V_ROUND_TRIP,) + gpt.latent_shape \
            or tuple(rec.shape) != tuple(clips.shape) or not bool(torch.isfinite(rec).all()):
        fail(f"t2v: VQ-VAE codes {tuple(codes.shape)}, reconstruction {tuple(rec.shape)}")
    share = float((codes == codes32).float().mean())
    result["vqvae"] = {"clips": T2V_ROUND_TRIP, "encode_s": t1 - t0, "decode_s": t2 - t1,
                       "code_agreement_bf16_fp32": share}
    print(f"t2v: VQ-VAE round trip of {T2V_ROUND_TRIP} clips {tuple(clips.shape)} -> "
          f"{tuple(codes.shape)} -> {tuple(rec.shape)}: encode {t1 - t0:.3f} s, decode "
          f"{t2 - t1:.3f} s; codes equal to fp32's: {share:.4f}", flush=True)
    del clips, rec, codes, codes32, ref, server, gpt
    torch.cuda.empty_cache()

    # 7. VideoGPT (video -> video) teacher-forced at its published widths
    vg = video_gpt(dtype=torch.bfloat16, seed=2, **VIDEO_GPT_WIDTHS)
    randomize_to_logit(vg, 20)
    vg32 = video_gpt(dtype=torch.float32, seed=3, **VIDEO_GPT_WIDTHS)
    vg32.load_state_dict(vg.state_dict())
    vshape = VIDEO_GPT_WIDTHS.get("input_shape", (16, 64, 64))
    gen = torch.Generator(device="cuda").manual_seed(22)
    v_in, v_out = (torch.rand((1,) + tuple(vshape) + (3,), device="cuda", generator=gen) - 0.5
                   for _ in range(2))
    vlayers, vd = vg.mm_decoder.decoder.num_layers, vg.d_model
    with torch.no_grad():
        tin, tout = vg.encode(v_in, "in"), vg.encode(v_out, "out")
        vg(in_tokens=tin[:, :64], out_tokens=tout[:, :64], causal=True, right_shift=True)
        torch.cuda.synchronize()
        reset_counts(fe, fa, qa)
        t0 = time.perf_counter()
        lb = vg(in_tokens=tin, out_tokens=tout, causal=True, right_shift=True).logits
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        counts = path_counts(fe, fa, qa)
        lf = vg32(in_tokens=tin, out_tokens=tout, causal=True, right_shift=True).logits
    expect("video_gpt teacher-forced forward", counts,
           {"fused_mlp": vlayers * int(fe.fused_mlp_available(vd, 4 * vd, vd))})
    paths_out["video_gpt_forward"] = counts
    vcos = float(cosine_rows(lb[0].cpu().numpy(), lf[0].cpu().numpy()).min())
    result["video_gpt"] = {"tokens": int(lb.shape[1]), "forward_s": fwd_s, "cosine": vcos,
                           "latent_shape": list(vg.latent_shape)}
    print(f"t2v: video_gpt ({tuple(vshape)} -> {vg.latent_shape}, d_model {vd}, "
          f"{vg.mm_decoder.decoder.n_head} heads, {vlayers} layers) teacher-forced over "
          f"{lb.shape[1]} tokens at batch 1 in {fwd_s * 1e3:.1f} ms; bf16 vs fp32 lowest row "
          f"cosine {vcos:.6f} (bar {T2V_COSINE})", flush=True)
    if vcos < T2V_COSINE:
        fail(f"video_gpt: logits cosine {vcos} below {T2V_COSINE}")
    del vg, vg32, lb, lf
    torch.cuda.empty_cache()
    result["wall_s"] = time.perf_counter() - phase_t0
    print(f"t2v: phase wall time {result['wall_s']:.1f} s", flush=True)
    return paths_out, result


VQA_STEPS = 5
VQA_EVAL = 32
VQA_MAX_BOXES = 8
VQA_HEADS = {"answer_type": 5, "answer_obj": 3, "answer_rel": 1594, "answer_attr": 403,
             "answer_cat": 678, "answer_global": 111}


def vqa_batches(rng, b: int, n: int):
    """``n`` seeded GQA-format batches at MDETR's sizes: images of 800 x
    1066 and 1066 x 800 padded to 1066 x 1066, questions of up to 64 tokens
    (the first of each batch 64 long), up to 8 boxes each with its token
    span, and the six heads' answers with their answer-type masks."""
    from multimodal_tpu_torch.models.mdetr.model import pad_images, pad_text

    for _ in range(n):
        images, image_mask = pad_images([
            rng.random((MDETR_SHORT, MDETR_LONG, 3) if i % 2 == 0
                       else (MDETR_LONG, MDETR_SHORT, 3), dtype=np.float32) for i in range(b)])
        lens = [MDETR_TEXT] + [int(rng.integers(8, MDETR_TEXT + 1)) for _ in range(b - 1)]
        text, text_mask = pad_text([rng.integers(3, 50000, n_tok) for n_tok in lens])
        n_box = rng.integers(1, VQA_MAX_BOXES + 1, b)
        positive_map = np.zeros((b, VQA_MAX_BOXES, 256), np.float32)
        for i in range(b):
            for j in range(n_box[i]):
                start = int(rng.integers(0, lens[i] - 2))
                positive_map[i, j, start:start + 2] = 0.5
        centres = rng.uniform(0.25, 0.75, (b, VQA_MAX_BOXES, 2))
        sizes = rng.uniform(0.05, 0.4, (b, VQA_MAX_BOXES, 2))
        answer_type = rng.integers(0, 5, b)
        yield {"images": images, "image_mask": image_mask, "text": text,
               "text_attention_mask": text_mask, "positive_map": positive_map,
               "target_boxes": np.concatenate([centres, sizes], -1).astype(np.float32),
               "valid": np.arange(VQA_MAX_BOXES)[None, :] < n_box[:, None],
               "answers": {k: rng.integers(0, v, b) for k, v in VQA_HEADS.items()},
               "answer_type_mask": {
                   "answer_type": np.ones(b, bool), "answer_obj": answer_type == 0,
                   "answer_attr": answer_type == 1, "answer_rel": answer_type == 2,
                   "answer_cat": answer_type == 3, "answer_global": answer_type == 4}}


def mdetr_vqa_launches(fe, attn, batch: int) -> dict:
    """One VQA training step's launches: the forward's (``mdetr_launches``,
    the model deterministic as the JAX loss runs it) and the backward of
    each: #2 for every #1, the flash backward (#7 + #8 as one call) for
    every #6, and #4 or #5 for every #3 by ``fused_mlp_bwd_acc_supported``
    at its rows. The answer heads' and the box head's MLPs take no kernel."""
    fwd = mdetr_launches(fe, attn)
    out = dict(fwd)
    out["fused_qkv_attention_bwd"] = fwd.get("fused_qkv_attention", 0)
    out["flash_attention_bwd"] = fwd.get("flash_attention", 0)
    text = text_tower_launches(fe, MDETR_TEXT, 12, False).get("fused_mlp", 0)
    mlp = int(fe.fused_mlp_available(256, 2048, 256))
    out.update(mlp_bwd_routes(fe, [(batch * MDETR_TEXT, 768, 3072, 768, text),
                                   (batch * MDETR_SEQ, 256, 2048, 256, 6 * mlp),
                                   (batch * MDETR_QUERIES, 256, 2048, 256, 6 * mlp)]))
    return out


def vqa_phase(fe, fa, qa, attn, card):
    """Phase 17: MDETR VQA fine-tuning (see the module docstring)."""
    from multimodal_tpu_torch.data.device_prefetch import to_device
    from multimodal_tpu_torch.examples.mdetr import vqa_finetune as vf
    from multimodal_tpu_torch.models.mdetr.model import mdetr_for_vqa
    from multimodal_tpu_torch.training.trainer import Trainer

    phase_t0 = time.perf_counter()
    t0 = time.perf_counter()
    model = mdetr_for_vqa(dtype=torch.bfloat16, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"vqa: mdetr_for_vqa (ResNet-101, RoBERTa-base, d_model 256, 8 heads of 32, 6 + 6 "
          f"layers, 100 + 6 queries, the six GQA heads), {n_params / 1e6:.1f}M parameters (fp32, "
          f"bf16 compute), built in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(23)
    t0 = time.perf_counter()
    train = list(vqa_batches(rng, VQA_BATCH, VQA_STEPS + 3))
    evals = list(vqa_batches(rng, VQA_BATCH, VQA_EVAL // VQA_BATCH))
    print(f"vqa: {len(train) + len(evals)} seeded GQA-format batches of {VQA_BATCH} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    result, paths_out = {}, {}
    cuda = torch.device("cuda")
    loss_fn = vf.vqa_loss_fn()

    # warm-up: a forward and backward, no update (cuDNN's plans)
    model.train()
    loss, _ = loss_fn(model, to_device(train[0], cuda))
    loss.backward()
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    p0 = model.model.query_embed.detach().clone()

    # 1. five fine-tuning steps with EMA (finetune_vqa: one chunk of 5)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fe, fa, qa)
    t0 = time.perf_counter()
    model, ema = vf.finetune_vqa(model, iter(train[1:1 + VQA_STEPS]), num_steps=VQA_STEPS,
                                 trainer_kwargs={"log_interval": 1})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = path_counts(fe, fa, qa)
    expect(f"vqa fine-tuning ({VQA_STEPS} steps)", counts,
           {k: VQA_STEPS * v for k, v in mdetr_vqa_launches(fe, attn, VQA_BATCH).items()})
    paths_out["mdetr_vqa_train"] = counts
    # the EMA's chunk rule: 5 updates toward the chunk's final parameters
    d = 0.9998 ** VQA_STEPS
    p5 = model.model.query_embed.detach()
    want = p0 * d + p5 * (1 - d)
    ema_err = float((ema.model.query_embed - want).abs().max() / want.abs().max())
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    if not finite or ema_err > 1e-5:
        fail(f"vqa: finite parameters {finite}, EMA relative error {ema_err}")
    result.update(items_per_s=VQA_BATCH * VQA_STEPS / dt, ms_per_step=dt / VQA_STEPS * 1e3,
                  peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, ema_rel_err=ema_err)
    print(f"vqa: fine-tuning {result['items_per_s']:.2f} questions/s, "
          f"{result['ms_per_step']:.1f} ms a step at batch {VQA_BATCH} (the optimizer, its "
          f"schedule and the EMA included), peak memory {result['peak_gib']:.2f} GiB, EMA "
          f"against its chunk formula {ema_err:.2e} on {card}", flush=True)

    # one more step through the trainer, profiled
    opt, sched = vf.build_vqa_optimizer(model, num_training_steps=2, steps_per_epoch=2)
    opt.register_step_post_hook(lambda *_: sched.step())
    trainer = Trainer(loss_fn, opt, device=cuda, log_interval=1)
    trainer.fit(model, iter([train[-2]]), 1)
    breakdown = profile_step(lambda: trainer.fit(model, iter([train[-1]]), 1), "vqa train")
    if isinstance(breakdown, dict):
        result["idle_share"] = 1 - breakdown["total_device_ms"] / breakdown[
            "wall_ms_under_profiler"]
    result["profile"] = breakdown
    losses = [r["loss"] for r in trainer.logger.records if "loss" in r]
    if not all(math.isfinite(x) for x in losses):
        fail(f"vqa: losses {losses}")
    print(f"vqa: device time of one fine-tuning step by kernel group {json.dumps(breakdown)}; "
          f"idle share {result.get('idle_share', float('nan')):.4f}; losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    del opt, sched, trainer

    # 2. evaluate_vqa over 32 examples
    model.eval()
    reset_counts(fe, fa, qa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = vf.evaluate_vqa(model, evals)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    counts = path_counts(fe, fa, qa)
    expect(f"vqa evaluation ({len(evals)} forwards)", counts,
           {k: len(evals) * v for k, v in mdetr_launches(fe, attn).items()})
    paths_out["mdetr_vqa_eval"] = counts
    result.update(eval_images_per_s=VQA_EVAL / eval_s, accuracy=acc)
    print(f"vqa: evaluate_vqa over {VQA_EVAL} examples in {eval_s:.2f} s "
          f"({result['eval_images_per_s']:.2f} images/s), accuracies (random weights) "
          f"{json.dumps({k: round(v, 4) for k, v in acc.items()})}", flush=True)

    # 3. the bf16 gradients against an fp32 copy's on the card, at the
    # fine-tuning batch (the kernels' own cases hold them to their plain
    # versions in phase 2)
    ref = mdetr_for_vqa(dtype=torch.float32, seed=1)
    ref.load_state_dict(model.state_dict())
    batch = to_device(train[1], cuda)
    grads = []
    for m in (model, ref):
        m.train()
        m.zero_grad(set_to_none=True)
        loss, _ = loss_fn(m, batch)
        loss.backward()
        grads.append(torch.cat([p.grad.double().flatten() for p in m.parameters()
                                if p.grad is not None]))
    gcos = float(grads[0] @ grads[1] / (grads[0].norm() * grads[1].norm()))
    print(f"vqa: gradient cosine, bf16 vs fp32 on the card at {VQA_BATCH} questions "
          f"{gcos:.6f} (bar {SLICE10_COSINE})", flush=True)
    if not gcos >= SLICE10_COSINE:
        fail(f"vqa: gradient cosine {gcos} below {SLICE10_COSINE}")
    result["grad_cosine"] = gcos
    del ref, grads, model, ema
    torch.cuda.empty_cache()
    result["wall_s"] = time.perf_counter() - phase_t0
    print(f"vqa: phase wall time {result['wall_s']:.1f} s", flush=True)
    return paths_out, result


SCRIPT_T0 = time.perf_counter()
PHASE_S = {}  # each phase's wall seconds, by its function's name


def timed_phase(fn, *args):
    """``fn(*args)``, its wall seconds kept in ``PHASE_S``."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[fn.__name__] = round(time.perf_counter() - t0, 1)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU",
              file=sys.stderr)
        sys.exit(2)
    from multimodal_tpu_torch.ops import _build
    from multimodal_tpu_torch.ops import attention as attn
    from multimodal_tpu_torch.ops import flash_attention as fa
    from multimodal_tpu_torch.ops import fused_encoder as fe
    from multimodal_tpu_torch.ops import kv_cache as kv
    from multimodal_tpu_torch.ops import quantized_attention as qa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"device: {card} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if "--ab" in sys.argv[1:]:
        ab(sys.argv[sys.argv.index("--ab") + 1])
        print("ab: done; no result line", flush=True)
        return
    if "--planted-faults" in sys.argv[1:]:
        planted_faults()
        print("planted faults: each failed at least one case; no result line", flush=True)
        return
    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    print(f"build: {lib.name} in {build_s:.1f} s (nvcc -gencode arch=compute_90a,code=sm_90a)",
          flush=True)
    if _build.build_log:
        for line in _build.build_log.splitlines():
            if ("registers" in line or "spill" in line or "entry function" in line
                    or "C75" in line or line.startswith("==")):  # C75xx: wgmma serialized
                print("  " + line.strip(), flush=True)

    PHASE_S["build"] = round(build_s, 1)
    t0 = time.perf_counter()
    cases = (check_kernels(fe) + check_mlp_kernel(fe) + check_acc_kernel(fe)
             + check_new_kernels(fa, qa, kv) + check_bwd_kernels(fa)
             + check_slice10_kernels(fe, fa) + check_slice11_kernels(fe, fa))
    bwd_rows = flash_bwd_timing(fa)
    cases += bwd_rows
    bad = [c for c in cases if not c["ok"]]
    if bad:
        fail(f"{len(bad)} kernel case(s) outside tolerance: "
             + ", ".join(f"{c['kernel']}/{c['case']}/{c['dtype']}" for c in bad))
    threshold = flash_threshold(fa, attn, torch.Generator(device="cuda").manual_seed(2))
    print(f"threshold: flash vs the plain path, (8, 12, S, 64) bf16 causal: {json.dumps(threshold)}"
          f"; FLASH_MIN_SEQ = {attn.FLASH_MIN_SEQ}", flush=True)
    cross = cross_attention_reading(fa, attn, torch.Generator(device="cuda").manual_seed(3))
    print(f"threshold: #6 vs the plain path at ALBEF's cross-attention, bf16 non-causal: "
          f"{json.dumps(cross)}; the path takes the plain one below FLASH_MIN_SEQ = "
          f"{attn.FLASH_MIN_SEQ} queries", flush=True)
    routes = attention_bwd_routes(fe)
    print(f"threshold: #2's mma.sync vs wgmma kernel, (256, S, 3D) bf16 at head width 64: "
          f"{json.dumps(routes)}; _BWD_WGMMA_MIN_SEQ = {fe._BWD_WGMMA_MIN_SEQ}", flush=True)
    acc_rows = acc_threshold(fe)
    print(f"threshold: #5 vs #4 + library dW, (rows, 768, 3072, 768) bf16 exact GELU: "
          f"{json.dumps(acc_rows)}; _ACC_MIN_ROWS = {fe._ACC_MIN_ROWS}", flush=True)
    PHASE_S["kernel_cases"] = round(time.perf_counter() - t0, 1)
    if "--kernels-only" in sys.argv[1:]:
        print("kernels only: every case within tolerance; no result line", flush=True)
        return

    serve_launches, min_cos, device_rate, served_rate = timed_phase(serve, fe, card)
    launches, grad_cos, train_rate, step_ms, peak = timed_phase(train, fe, card)
    b16_launches, b16_cos, b16_step_launches, b16_step_ms = timed_phase(vit_b16_grad_check, fe,
                                                                        card)
    vit_cos = timed_phase(vit_l14_check, card)
    lm_launches, lm = timed_phase(lm_serve, fe, fa, qa, card)
    train_launches, lm_tr = timed_phase(lm_train, fe, fa, card)
    flava_launches, flava = timed_phase(flava_train, fe, fa, card)
    real_launches, real = timed_phase(flava_real, fe, fa, card)
    zs = timed_phase(zero_shot, fe, fa, card)
    albef_launches_by_path, albef_result = timed_phase(albef, fe, fa, attn, card)
    coca_launches_by_path, coca = timed_phase(coca_phase, fe, fa, qa, attn, card)
    blip2_launches_by_path, blip2 = timed_phase(blip2_phase, fe, fa, qa, attn, card)
    mugen_launches_by_path, mugen = timed_phase(mugen_phase, fe, fa, qa, attn, card)
    mdetr_launches_by_path, mdetr = timed_phase(mdetr_phase, fe, fa, qa, attn, card)
    t2v_launches_by_path, t2v = timed_phase(t2v_phase, fe, fa, qa, attn, card)
    vqa_launches_by_path, vqa = timed_phase(vqa_phase, fe, fa, qa, attn, card)
    print(f"phases: wall seconds {json.dumps(PHASE_S)}", flush=True)

    # every path's launch counts, each read just after the path ran with the
    # counts set to 0 just before it; a kernel's `launches` is its count on
    # its main path, the path whose shapes its head case (below) checks and
    # times
    paths = {"serve": serve_launches, "train": launches, "lm": lm_launches,
             "lm_train": train_launches, "flava": flava_launches,
             "train_grad_check": {"fused_mlp_bwd": launches["fused_mlp_bwd_grad_check"]},
             "vit_b16_grad_check": b16_launches, "vit_b16_train": b16_step_launches,
             "lm_train_grad_check": {"fused_mlp_bwd": train_launches["fused_mlp_bwd_grad_check"]},
             "flava_grad_check": {"fused_mlp_bwd": flava_launches["fused_mlp_bwd_grad_check"]},
             **real_launches,
             **{f"zero_shot_{m}_{part}": zs[m][f"{part}_launches"]
                for m in ("vit_b32", "rn50") for part in ("classifier", "eval")},
             **{f"zero_shot_{name}": c for name, c in zs["rn_builders"].items()},
             **albef_launches_by_path, **coca_launches_by_path, **blip2_launches_by_path,
             **mugen_launches_by_path, **mdetr_launches_by_path, **t2v_launches_by_path,
             **vqa_launches_by_path}
    main_path = {"fused_qkv_attention": "serve", "fused_qkv_attention_bwd": "train",
                 "fused_mlp": "flava", "fused_mlp_bwd": "flava_grad_check",
                 "fused_mlp_bwd_acc": "flava", "flash_attention": "lm",
                 "quantized_cache_attention": "lm", "flash_attention_bwd": "lm_train",
                 "flash_attention_bwd_dbias": "lm_train"}

    def path_launches(name):
        out = {"launches": paths[main_path[name]][name]}
        out.update({f"launches_{p}": c[name] for p, c in paths.items() if name in c})
        return out

    kernels = []
    for name, source, replaces, head_case in (
        ("fused_qkv_attention", "multimodal_tpu_torch/csrc/fused_qkv_attention.cu",
         "multimodal_tpu/ops/fused_encoder.py:200", "vision"),
        ("fused_qkv_attention_bwd", "multimodal_tpu_torch/csrc/fused_qkv_attention_bwd.cu",
         "multimodal_tpu/ops/fused_encoder.py:317", "vision"),
        ("fused_mlp", "multimodal_tpu_torch/csrc/fused_mlp.cu",
         "multimodal_tpu/ops/fused_encoder.py:500", "flava_image"),
        ("fused_mlp_bwd", "multimodal_tpu_torch/csrc/fused_mlp_bwd.cu",
         "multimodal_tpu/ops/fused_encoder.py:603", "flava_grad_image"),
        ("fused_mlp_bwd_acc", "multimodal_tpu_torch/csrc/fused_mlp_bwd_acc.cu",
         "multimodal_tpu/ops/fused_encoder.py:706", "flava_mm"),
        ("flash_attention", "multimodal_tpu_torch/csrc/flash_attention_fwd.cu",
         "multimodal_tpu/ops/flash_attention.py:336", "prefill"),
        ("quantized_cache_attention", "multimodal_tpu_torch/csrc/quantized_cache_attention.cu",
         "multimodal_tpu/ops/quantized_attention.py:117", "decode"),
    ):
        mine = [c for c in cases if c["kernel"] == name]
        head = next(c for c in mine if c["case"] == head_case and c["dtype"] == "bfloat16")
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            **path_launches(name),
            "max_abs_err": head["max_abs_err"],
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "passed": all(c["ok"] for c in mine),
        }
        if "staged_ms" in head:
            entry["staged_ms"] = head["staged_ms"]  # the route #5 replaces: #4 + library dW
        entry["cases"] = [{k: c[k] for k in ("case", "dtype", "max_abs_err", "rel_err", "tol",
                                             "ms", "stage_ms", "device_ms", "library_device_ms",
                                             "plain_ms", "library_ms", "staged_ms", "tflops",
                                             "bound_ms", "bound_by", "deterministic", "bar",
                                             "plain_rel_err", "route")
                           if k in c}
                          for c in mine]
        kernels.append(entry)
    # one entry per pallas_call: :625 (dq) and :650 (dk, dv) both name the
    # one call that replaces them, with its one time
    bwd_checks = [c for c in cases
                  if c["kernel"] == "flash_attention_bwd" and c["case"] != "train"]
    fused_row, dbias_row = bwd_rows
    for row, line, parts in ((fused_row, 625, ("dq",)), (fused_row, 650, ("dk", "dv")),
                             (dbias_row, 679, ("ds",))):
        name = row["kernel"]
        kernels.append({
            "name": name, "route": "cuda", "source": "multimodal_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"multimodal_tpu/ops/flash_attention.py:{line}", "parts": list(parts),
            **path_launches(name),
            "max_abs_err": max(row["max_abs_err_by_part"][n] for n in parts),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "passed": row["ok"] and all(c["ok"] for c in bwd_checks),
            "cases": [{"case": c["case"], "dtype": c["dtype"],
                       "tol": {n: c["tol"][n] for n in parts},
                       "rel_err": {n: c["rel_err"][n] for n in parts},
                       **{k: c[k] for k in ("deterministic", "relaunch_dq_rel_err", "ms",
                                            "plain_ms", "library_ms", "bound_ms", "bound_by")
                          if k in c}}
                      for c in bwd_checks if parts[0] in c["rel_err"]]})
    print(f"summary: serve min cosine {min_cos:.6f}, {device_rate:.1f} pairs/s device, "
          f"{served_rate:.1f} pairs/s served; train gradient cosine {grad_cos:.6f}, "
          f"{train_rate:.1f} items/s, {step_ms:.1f} ms a step, peak {peak / 2**30:.2f} GiB; "
          f"ViT-B/16 gradient cosine {b16_cos:.6f}, {b16_step_ms:.1f} ms a step; "
          f"ViT-L/14 cosine {vit_cos:.6f}; LM serving "
          f"{lm['prefill_tokens_per_s']:.1f} prefill tokens/s, "
          f"{lm['decode_tokens_per_s']:.1f} decode tokens/s, {lm['ms_per_tick']:.2f} ms a tick "
          f"(device {lm.get('device_ms_per_tick', float('nan')):.2f}), TTFT p50 "
          f"{lm['ttft_p50_s']:.3f} s, peak {lm['peak_gib']:.2f} GiB, logit "
          f"cosine {lm['min_cosine']:.6f}; LM training {lm_tr['tokens_per_s']:.1f} tokens/s, "
          f"{lm_tr['ms_per_step']:.1f} ms a step, peak {lm_tr['peak_gib']:.2f} GiB, gradient "
          f"cosine {lm_tr['grad_cosine']:.6f}; FLAVA pretraining {flava['items_per_s']:.1f} "
          f"items/s, {flava['ms_per_step']:.1f} ms a step, peak {flava['peak_gib']:.2f} GiB, "
          f"gradient cosine {flava['grad_cosine']:.6f}; FLAVA from real data "
          f"{real['items_per_s']:.1f} items/s, {real['ms_per_step']:.1f} ms a step, peak "
          f"{real['peak_gib']:.2f} GiB, host {real['host_ms_per_image']:.2f} ms an image, idle "
          f"share {real.get('idle_share', float('nan')):.4f}, six-loss gradient cosine "
          f"{real['grad_cosine']:.6f}, dVAE cosine {real['dvae_cosine']:.6f} (less channel "
          f"means {real['dvae_centred_cosine']:.6f}; labels agree "
          f"{real['dvae_label_agreement']:.4f} over {real['dvae_distinct_labels']} distinct), "
          f"resume max diff "
          f"{max(real['resume']['max_rel_diff_by_step'].values()):.3g}, evals "
          f"{json.dumps({k: round(v['seconds'], 2) for k, v in real['evals'].items()})} s, phase "
          f"{real['wall_s']:.1f} s; zero-shot ViT-B/32 "
          f"{zs['vit_b32']['prompts_per_s']:.1f} prompts/s to the classifier, "
          f"{zs['vit_b32']['images_per_s']:.1f} images/s, cosines "
          f"{zs['vit_b32']['classifier_cosine']:.6f} / {zs['vit_b32']['logit_cosine']:.6f}; RN50 "
          f"{zs['rn50']['prompts_per_s']:.1f} prompts/s, {zs['rn50']['images_per_s']:.1f} "
          f"images/s, cosines {zs['rn50']['classifier_cosine']:.6f} / "
          f"{zs['rn50']['logit_cosine']:.6f}; transform+encode p50 "
          f"{zs['latency']['ids']['p50_ms']:.3f} ms from ids, "
          f"{zs['latency']['strings']['p50_ms']:.3f} ms from strings; zero-shot phase "
          f"{zs['wall_s']:.1f} s; ALBEF retrieval {albef_result['items_per_s']:.1f} items/s, "
          f"{albef_result['ms_per_step']:.1f} ms a step, peak {albef_result['peak_gib']:.2f} "
          f"GiB, idle share {albef_result.get('idle_share', float('nan')):.4f}, the stream "
          f"alone {albef_result['stream_ms_per_batch']:.1f} ms a batch, the step on drawn "
          f"batches {albef_result['drawn_ms_per_step']:.1f} ms, gradient cosine "
          f"{albef_result['grad_cosine']:.6f}, feature cosines "
          f"{json.dumps({k: round(v, 6) for k, v in albef_result['feature_cosines'].items()})}, "
          f"rerank {albef_result['rerank_s']:.2f} s; ALBEF VQA "
          f"{albef_result['vqa_items_per_s']:.1f} questions/s, gradient cosine "
          f"{albef_result['vqa_grad_cosine']:.6f}; ALBEF phase {albef_result['wall_s']:.1f} s; "
          + "; ".join(
              f"{name} training {r['items_per_s']:.1f} items/s, {r['ms_per_step']:.1f} ms a step, "
              f"peak {r['peak_gib']:.2f} GiB, idle share {r.get('idle_share', float('nan')):.4f}, "
              f"gradient cosine {r['grad_cosine']:.6f}, output cosines "
              f"{json.dumps({k: round(v, 6) for k, v in r['output_cosines'].items()})}; "
              f"{name} captioning {r['serving']['captions_per_s']:.2f} captions/s, "
              f"{r['serving']['decode_tokens_per_s']:.1f} decode tokens/s, "
              f"{r['serving']['host_ms_per_tick']:.2f} ms a tick (device "
              f"{r['serving'].get('device_ms_per_tick', float('nan')):.2f}), TTFT p50 "
              f"{r['serving']['ttft_p50_s']:.3f} s, teacher-forced cosine "
              f"{r['serving']['teacher_forced_cosine']:.6f}; {name} phase {r['wall_s']:.1f} s"
              for name, r in (("CoCa", coca), ("BLIP-2", blip2)))
          + f"; MUGEN retrieval training {mugen['items_per_s']:.2f} items/s, "
          f"{mugen['ms_per_step']:.1f} ms a step, peak {mugen['peak_gib']:.2f} GiB, idle share "
          f"{mugen.get('idle_share', float('nan')):.4f}, recall "
          f"{json.dumps({k: round(v, 4) for k, v in mugen['recall'].items()})}, cosines "
          f"{json.dumps({k: round(v, 6) for k, v in mugen['output_cosines'].items()})}, phase "
          f"{mugen['wall_s']:.1f} s; MDETR grounding {mdetr['images_per_s']:.2f} images/s, "
          f"fine-tuning {mdetr['ms_per_step']:.1f} ms a step, peak {mdetr['peak_gib']:.2f} GiB, "
          f"matcher {mdetr['matcher_host_ms']:.2f} ms, idle share "
          f"{mdetr.get('idle_share', float('nan')):.4f}, cosines "
          f"{json.dumps({k: round(v, 6) for k, v in mdetr['output_cosines'].items()})}, phase "
          f"{mdetr['wall_s']:.1f} s; MUGEN text-to-video "
          f"{t2v['serving']['videos_per_s']:.3f} videos/s served, "
          f"{t2v['serving']['decode_tokens_per_s']:.1f} decode tokens/s, "
          f"{t2v['serving']['host_ms_per_tick']:.2f} ms a tick (device "
          f"{t2v['serving'].get('device_ms_per_tick', float('nan')):.2f}), TTFT p50 "
          f"{t2v['serving']['ttft_p50_s']:.3f} s, GenerationUtil "
          f"{t2v['sampler']['ms_per_step']:.2f} ms a step, teacher-forced cosine "
          f"{t2v['teacher_forced_cosine']:.6f}, VQ codes equal to fp32 "
          f"{t2v['vqvae']['code_agreement_bf16_fp32']:.4f}, video_gpt cosine "
          f"{t2v['video_gpt']['cosine']:.6f}, phase {t2v['wall_s']:.1f} s; MDETR VQA "
          f"{vqa['ms_per_step']:.1f} ms a step, idle share "
          f"{vqa.get('idle_share', float('nan')):.4f}, gradient cosine "
          f"{vqa['grad_cosine']:.6f}, eval {vqa['eval_images_per_s']:.2f} images/s, phase "
          f"{vqa['wall_s']:.1f} s"
          + f"; build {build_s:.1f} s; script {time.perf_counter() - SCRIPT_T0:.1f} s",
          flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
