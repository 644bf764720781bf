#!/usr/bin/env python3
"""Drive kjarni_tpu_torch's generation, encoder-decoder, embed and search
paths, the decoder's infrastructure, f32 on the card, the user surfaces
(the CLI, the C ABI), parallelism and the training step on one CUDA card
and check them.

    python3 chip_smoke.py [--phases env,kernels,bf16,int4,int8,batch,chat,gpt2,serve,
                                    infra,f32,surfaces,parallel,train,seq2seq,whisper,
                                    embed,search,zoo]
                          [--root DIR]

--root DIR imports kjarni_tpu_torch from another checkout (an older commit,
say) instead of this one, to time its kernels on these same cases.

Phases, in order (all by default); any failure raises and exits non-zero:

1. env: torch/CUDA versions, the card's name and power limit, which optional
   packages import, python3-config, Python.h, g++ and gcc (the C ABI embeds
   CPython; missing, the phase fails), and the build of every kernel from
   kjarni_tpu_torch/csrc.
2. kernels: each hand-written kernel against its plain PyTorch version on the
   card, in bf16, at the generation path's shapes (flash: Llama-1B prefill at
   1024 and 512, Phi-3.5-mini's D = 96 prefill, the follow-up request's
   cache-reuse shape and smaller cases for the other features; int4: every
   projection at M = 1 for decode, M = 8, 32, 64, 128 and 1024 for prefill
   buckets, M = 8192 for a batched prefill (8 rows at bucket 1024) and M = 8
   for a batched decode step, M = 5 for the speculative target pass, M = 256
   and 512 for the continuous engine's system prompt and single-lane
   admission waves and M = 16,384 for its 8-lane admission wave at bucket
   2048, and the head at M = 1 and at M = 8 (the batch's prefill and decode
   steps); flash also at that admission wave (B 8, S 2048 after a 256-token
   prefix, over 2,304 slots) and at whisper-small's encoder (non-causal,
   12 heads, S = T = 1500, B = 1 and 8, held to 1.5% of the largest output,
   which a causal call and a call dropping the last key must fail); two
   calls must give bit-identical outputs); one line per case with the
   launches the case made,
   max_abs_err, kernel_ms, plain_ms and library_ms, the time of one PyTorch
   call computing the same function as a yardstick the port never calls:
   scaled_dot_product_attention for flash (library_kernel names the device
   kernel it ran), torch._weight_int4pack_mm (tinygemm, checked against the
   plain version first) for int4. The cache-reuse lines also time the
   materialized attention that _run_stack runs where flash is not taken
   (materialized_ms). At M = 1 the int4 line also has gemm_ms: the prefill
   GEMM on the same input, beside the GEMV that decode takes. Then f32: the
   f32 flash kernel at the Llama-1B prefill, the follow-up's cache reuse,
   Phi-3.5-mini's D = 96, a window of 64, D = 128 and 32, and whisper-small's
   encoder shape (B 1, 12 heads, S = T = 1500, non-causal; off the path, as
   the f32 Transcriber runs plain attention), each within 1e-5 of the plain
   output's largest magnitude, bit-identical on a repeat, a call dropping the
   last key and the TF32-only control (the kernel without its split's small
   terms) outside that bound, SDPA on the same f32 tensors as the yardstick
   (its backend named), and two bounds from the f32 bytes: the 3xTF32
   design's (three TF32 products per operation at 495 TFLOP/s, bound_ms) and
   the FFMA design's (66.9 TFLOP/s, bound_ms_ffma); and int4 with f32 activations
   at M = 1 (every projection and the head), 8 and 1024: f32 output, held to
   the plain version with x rounded to bf16 (x_as_bf16) by the int4 check,
   bit-identical on a repeat, and per decoded token the parent's form (the
   wrapper's x cast, then the kernel) against the GEMV that rounds f32 x
   itself, device and eager ms, bit-identical. Then both kernels at phase
   19's shapes: flash, bf16 and f32, at each zoo decoder's prefill (S = T =
   1024) and its follow-up's cache reuse (S 1024 at q_offset 732 or 733 over
   a kv bucket of 1792): G = 7 (H14 Hkv2 D64), 6 (H12 Hkv2 D128), 3 (H24
   Hkv8 D128), 1 (Phi-3.5-mini, D96) and 4 (H32 Hkv8 D128), and
   whisper-large-v3's encoder (H20, S = T = 1500, non-causal); int4 at every
   zoo projection shape at M = 1 and 1024 and each head at M = 1, with one
   decoded token summed per model at its published depth (7 x layers + 1
   launches) and one layer at M = 1024. `--phases env,flash` runs the flash
   cases alone, bf16 and f32.
3. bf16: Generator over a Llama-3.2-1B-shaped checkpoint (full width, 16
   layers, random bf16 weights from a seeded generator on the card) answers
   three requests: a greedy generate on a ~700-token prompt (flash prefill), a
   follow-up extending it (prefix reuse: flash over the cache, or plain
   attention in an older checkout under its 2 GB score gate) and a 32-token
   generate_stream on another ~600-token prompt. Checks
   the flash launch count per request (one per layer, each call at the
   request's (S, T, q_offset, kv_len)), every greedy token within the 0.5
   logit tie band of a teacher-forced plain forward of prompt and output,
   and the first prefill's logits against the same forward with the
   kernels' plain versions.
4. int4: the same with quantize="int4"; checks 113 int4 launches per forward
   (7 projections x 16 layers + the lm_head, int4_per_forward), and every
   int4 launch of the first prefill held on its own input against the plain
   version (2e-2 of its largest output, cosine > 0.999).
5. int8: the phase-3 requests with quantize="int8" (16 flash launches per
   prefill bucket >= 512, no int4), the first prefill's logits against the
   bf16 weights' (cosine >= 0.999 over the first 2 layers, the JAX test's
   depth and bound; at full depth within twice the f32 quantization's own
   distance plus bf16's, which the same weights truncated instead of
   rounded must exceed, see int8_accuracy), prefill ms,
   decode tok/s and peak memory beside bf16; _mm's int8 branch against bf16
   matmuls per decoded token (device ms); then one kv_cache="int8" follow-up
   that prefills only its suffix with 16 flash launches over the dequantized
   cache slice, and the share of its 64 greedy ids that agree with the
   bf16-KV follow-up (a number, not a check: int8 KV is lossy).
6. batch: Generator.generate_batch on B = 8 ragged prompts of 300-700 tokens
   sharing a 64-token prefix, 64 new tokens, in bf16 and in int4: the shared
   prefix is found (64), each row's batch-prefill logits are held against
   the single-stream prefill of its prompt (cosine >= 0.998 in bf16, and
   >= 0.99999 in f32 with the plain kernels), and two faults planted in the
   batch prefill (RoPE at slot indices, the pad mask dropped) must read
   below each bound; no flash launches and, in int4, 113 per forward
   (prefix fill, prefill, decode steps); aggregate tok/s beside the single
   stream's, peak memory. Then B = 8 prompts of ~1,800 tokens (bucket 2048)
   with the bf16 and the int8 KV cache: the bf16-KV rows held against the
   single stream, the int8-KV rows against the bf16-KV rows (cosine >=
   0.995), each with the same planted faults; decode tok/s and peak
   memory. Then seeded sampled decoding,
   single-stream and batched: each seed repeats its stream, and every draw
   lies in its row's top-k / top-p / min-p set (computed apart, in numpy).
7. chat: Chat over the same weights (a tokenizer holding the llama3
   template's specials, <|eot_id|> a stop id), max_context 2048: three
   turns of ~700, +~600 and ~700 tokens; each prefills only what follows
   the cached prefix with 16 flash launches, and the third drops the
   oldest turn. Time to first token and tok/s per turn.
8. gpt2: a model dir at GPT-2's public config.json widths (12 layers, 768,
   12 heads, vocab 50,257, 1,024 positions; random f32 weights): a greedy
   generate on a 700-token prompt and a B = 8 generate_batch, with no flash
   and no int4 launch, and the card's bf16 logits against the f32 forward on
   the CPU at cosine >= 0.999.
9. serve: over the phase-3 weights' first 4 layers (full width) in bf16
   and in int4, a ContinuousEngine
   (8 slots of 4,096, windows of up to 8 steps, a 256-token system prompt
   registered once) serves 24 requests in three bursts (the later two join
   mid-flight): suffixes of 1,100-1,800 tokens in the first (one 8-lane
   admission wave at bucket 2048, the flash plan) and 100-1,000 in the
   others (plain plans), 32-128 new tokens, one in three sampled
   (temperature 0.8, top-k 50, top-p 0.9, seeded). One run is timed
   (aggregate tok/s, time to first token p50/p95, waves by plan, flash and
   int4 launches, int4 launches by M, peak memory); a second run of the same
   schedule must repeat every stream, each sampled draw must lie in its
   filter set, and every greedy token must lie within a bf16 tie band of
   0.5 logits of the maximum of a teacher-forced single-stream prefill of
   its prompt and output (plain kernels); on 8 more greedy requests, with
   the admission gate shrunk so that every wave takes the flash plan, three
   planted faults (a slot decoding at pos - 1; an admission scatter into a
   permuted slot; the flash wave's queries at q_offset 0 instead of after
   the prefix) must fail that check, and in f32 the cosine of each
   request's admission and first 4 decode rows against the same forward
   (>= 0.99999 sound, as the batch phase). Then SpeculativeGenerator
   (k = 4) with the target's first 2 layers as a draft and with a
   self-draft, in bf16 and int4: acceptance, tok/s beside the target's own
   stream, and the same teacher-forced check. Then serve.py's
   server on 127.0.0.1:0 (--scheduler continuous): /health, 8 concurrent
   /v1/generate, /v1/completions, a streamed /v1/chat/completions and
   /v1/batch_stats, each 200 with the engine's texts, and their latencies.
   Last a GGUF dir at Llama-3.2-1B width and 2 layers (Q8_0 embedding and
   projections, F32 norms, a byte-level BPE over 128,256 ids embedded),
   its weights drawn and quantized on the card: DecoderLM(dir) must give the params and the
   first-prefill logits of the same dequantized weights loaded from
   safetensors. `--phases env,serve` runs it alone.
10. seq2seq: model dirs at the public config.json widths of the registry's
   distilbart-cnn (12 + 6 layers, 1,024 wide, its summarization task
   parameters) and flan-t5-base (12 + 12 layers, 768 wide, gated-gelu,
   untied head), random bf16 weights from a seeded generator (T5's
   relative-position tables N(0, 1), the output heads N(0, 0.2): see
   write_encdec_dir) and a word-level tokenizer over the
   whole vocabulary with each model's specials. Summarizer(dir).summarize on
   an 800-word article (4 beams, min length 56, no-repeat 3, forced BOS/EOS)
   and Summarizer.stream; Translator(dir).translate on a 100-word sentence.
   Checks: a repeated call gives the same text; bf16 encoder states and
   first-step logits against f32 on the card (cosine >= 0.999 for BART,
   0.99 for T5: S2S_COS_MIN; for T5 also read with cuBLAS's reduced-precision
   bf16 reduction off, and bf16 against f32 on the CPU); f32 on the
   card against f32 on the CPU (states atol 2e-4 rtol 1e-3, logits of 24
   teacher-forced decoder tokens atol 1e-3); a padded BART row against the
   same input unpadded (atol 1e-3); in f32, over 64 steps, the device beam
   loop's tokens and its step-by-step trace (every beam's decode inputs and
   logits) equal the host loop's. Five planted faults must fail those bounds in
   every run: the self-cache not reordered by the beam parents (the loops
   then differ), the cross-attention padding bias dropped (the padded row),
   T5's decoder bias built bidirectional (card against CPU), and in the bf16
   T5 forward its encoder bias built unidirectional and its scores scaled
   by d_kv ** -0.5 (the bf16 cosine). No kernel
   launches. One line per model: seconds per call, decode steps/s (k beams
   a step), the encoder's device ms, peak memory, device busy share.
11. whisper: a model dir at whisper-small's public widths (12 + 12 layers,
   768 wide, 80 mels, vocabulary 51,865; random bf16 weights, the token
   and decoder-position tables N(0, 0.2)) with a
   tokenizer holding Whisper's specials at their fixed ids, driven through
   Transcriber on the card: a 30 s synthetic signal (serial), a 240 s one
   (8 chunks, one batched wave), stream_file, language="auto" and
   timestamps. The encoder takes the flash kernel (12 launches per encode
   call, checked). Checks: the mel on the card against the CPU's (atol
   2e-4); the encoder with flash against the plain attention in bf16 at B =
   1 and 8 (cosine >= 0.999 on every frame); each batched token within a
   0.5-logit tie band of a teacher-forced serial forward of its chunk
   (first 32 tokens of each row); in f32 the batched wave's greedy ids equal
   each chunk's serial decode. Planted faults that must fail: the encoder's
   flash called causal, the decoder's positions shifted by one. One line:
   real-time factor per input, decode tok/s of the wave, the encoder's
   device ms per wave with and without flash at B = 1 and 8 (CUDA-graph
   replay), peak memory, device busy share.
12. embed: four encoder model dirs at the public config.json widths of the
   registry's minilm-l6-v2, minilm-l6-v2-cross-encoder, distilbert-sentiment
   and nomic-embed-text (random f32 weights from a seeded generator, a
   BERT-template word tokenizer over the whole vocabulary), each driven
   through its task API on the card (Embedder, Reranker, Classifier,
   Embedder). Checks the bf16 task output against the same model in f32 on
   the card, the f32 hidden states on the card against the f32 forward on
   the CPU, and that neither hand-written kernel launched (the encoder runs
   plain torch ops, as the JAX package runs XLA ones). One line per model:
   the checks' errors, texts/s of 256 texts at seq 64 (tokenizer included,
   median of 5 calls), device ms of one B256 S64 forward (CUDA-graph
   replay), device busy share and top kernels of one profiled call, peak
   memory; for MiniLM also plain against packed encode at S = 64 and 32.
   `--phases env,embed` runs it alone.
13. search: model dirs at the public widths of minilm-l6-v2 and its
   cross-encoder (as phase 12), and a seeded corpus of 1,600 .txt / .md
   files of 5,000 characters of random BERT-vocabulary words (12,634 chunks
   at the default 1,000 / 200 split: a segment of 10,000 rows on the
   store's device branch and a tail of 2,634 in numpy). Indexer(dir).create
   on the card, its chunk and file counts against DocumentLoader on the same
   files, 256 stored embeddings against the f32 encoder on the card (cosine
   >= EMBED_COS_MIN). Searcher(dir, reranker_model=ce) answers 64 queries in
   semantic, keyword and hybrid mode, each with and without rerank (p50 /
   p95 ms). Checks: semantic top-10 ids equal an exact numpy f64 top-k over
   the stored embeddings (scores within 1e-5 of f64; a run of reference
   scores closer than 1e-5 compares as a set: topk_agrees), keyword results
   equal a device="cpu" searcher's, hybrid ids equal the RRF of the checked
   top-20 lists, rerank scores within RERANK_ATOL of the f32 cross-encoder,
   every text its document's. Three planted faults must fail those checks
   (SEARCH_FAULTS: the device matrix kept across add, segment-local ids,
   TF32-rounded scoring inputs). /v1/search through serve.py's server
   answers as the Searcher. Then a VectorStore of 1,000,000 x 384 seeded f32
   rows (1.54 GB on the card): the scoring product's device ms (CUDA-graph
   replay) beside its 0.46 ms byte bound, a search split into device, copy
   back and host top-k, peak memory, top-10 against numpy f64 (the TF32
   fault must fail it). Neither kernel launches. `--phases env,search`.
14. infra (run after phase 9, over its weights): Generator(dir,
   execution_plan="offload_ends") in bf16: the table in pinned host memory
   once (the tied head a view of it), at least the table's 525 MB fewer
   device bytes than the device plan, the first prefill's logits within
   cosine 0.999 and 2% of the largest logit of the device plan's, 16 flash
   launches per prefill, every greedy token of a 701-token request within
   the 0.5-logit tie band of a teacher-forced device-plan forward; prefill
   ms, stream tok/s and the host head and gather ms per token beside the
   device plan's. Two planted faults (INFRA_FAULTS: the head fed the
   pre-norm state, the gather's ids shifted by one) must fail the logits
   check. int4 under offload_embeddings (113 int4 launches per forward, the
   tie band) and offload_head (the quantized head stays on the card). The
   native checkpoint: convert_model to int4 on the card, DecoderLM(ckpt)
   bit-equal to the in-memory tree with the same greedy ids, load seconds
   of each. profiling.trace around one request holds its annotate span and
   the card's kernels; device_memory_report names the card. `--phases
   env,infra`.

15. f32 (run after phase 14, over its weights): Generator(dtype="f32") at
   full width (the bf16 weights loaded as f32, ~4.9 GB), plain and under
   quantize="int4": the first prefill's logits against the same forward on
   the plain versions (within F32_LOGITS_REL of the largest logit; under
   int4, whose kernel rounds x to bf16, no further from the plain f32 forward
   than twice the plain forward with x rounded to bf16 is), the 701-token
   request with 32 new tokens and a 32-token stream,
   each prefill 16 f32 flash launches and no bf16 one, 113 int4 launches per
   forward under int4; prefill ms, time to first token, decode tok/s and peak
   memory beside phase 3's bf16. Then the first 2 layers (a 2-layer dir of
   the same seeded weights, checked) in f32 on the card and on the CPU: 32
   greedy ids equal, or parting only where the CPU's top-2 logits lie within
   1e-4 (the gap reported). `--phases env,kernels,f32,surfaces`.
16. surfaces (over the same weights' first 4 layers, full width): the
   port's CLI in this process (kjarni_tpu_torch.cli.main.main) in a cwd
   whose kjarni.toml sets quantize = "int4" for the dir: generate --format
   json on the 701-token prompt (4 flash and 29 int4 launches; the text equals Generator's with
   the same options, which is empty: the CLI has no --max-length and the
   default max_length of 100 counts the prompt, as in the JAX CLI) and on a
   60-token prompt (32 tokens, int4 launches, the text equals Generator's);
   `python -m kjarni_tpu_torch embed` as a real subprocess on a MiniLM dir
   (within 1e-6 of the in-process Embedder); the port's libkjarni.so built
   by kjarni_tpu_torch/ffi/build.py from the checkout and driven through
   ctypes in this process (kjarni_init finds this interpreter): a generator
   with quantize int4, one kjarni_call and then one pull stream on the
   701-token prompt with max_length 4096 (both kernels launch; both texts
   equal a Generator's making the same two calls); the port's compiled C
   host as a subprocess on MiniLM,
   DistilBERT-SST-2 and a small llama dir with device cuda. Seconds of each
   step, and each surface's seconds beyond the Python API's for the same step
   (overhead_s; the CLI's include its model load).

17. parallel (run after 16, over the same weights): the port's parallel
   paths, each rank a process spawned on this card (every rank on cuda:0,
   gloo staged through host memory: the card count is 1; the env phase
   prints the card's compute mode, and anything but Default fails here).
   The decoder runs at full width over its first 4 layers (PAR_LAYERS).
   Two ranks: DecoderLM(tp=2) in bf16 on the 701-token prompt with 32 new
   greedy tokens, the ids equal on both ranks and teacher-forced within
   the 0.5-logit band of tp = 1 on this card (phase 8's gate); f32 tp = 2
   over the first 2 layers, prefill logits within 1e-4 of the largest f32
   tp = 1 logit; a dp = 2 MiniLM-L6 SentenceEncoder on 256 texts, f32 rows
   within 1e-5 of dp = 1 and bf16 rows at cosine >= 0.999 of f32;
   pipeline_forward at pp = 2 (2 layers a stage, n_micro 4, B 4 at S 1024)
   and pp_generate (32 tokens on B 2), and sequence_parallel_forward at
   sp = 2 (S 1024), each in the band of one process. Four ranks:
   DecoderLM(tp=4) in int4, as tp = 2. Each rank returns its kernel
   launches, which count as this phase's; prefill ms, decode tok/s and the
   pp / sp times are printed with the card's name, as ranks sharing one
   card, not a scale-out number. The server under SPMD (serve.py,
   serve_spmd.py), rank 0 serving on a loopback port and the other ranks
   following its model calls: at tp = 2 in bf16 under each scheduler
   (/v1/completions under the batch one, /v1/generate under the continuous
   one, the two sharing one model), after one request that builds the
   model, 4 concurrent clients of the 701-token prompt for 8 greedy
   tokens, each answer teacher-forced within the 0.5-logit band of tp = 1;
   at dp = 2 two concurrent /v1/embed clients on the 256 texts, bf16 rows
   (the server as it runs) at cosine >= 0.999 of dp = 1's and, with the
   encoder built in f32, f32 rows within 1e-5 of dp = 1; at tp = 4 an int4
   checkpoint's server (int4 runs), as tp = 2. Each rank job's seconds
   are printed (job_s), and the parent's own steps' (parent_s).
   The encoder families at tp = 2 (models/{bert,bart,t5,whisper}.py with
   tp=, each rank its shard under the family's rule): MiniLM-L6's encode,
   distilbart-cnn's and flan-t5-base's encode and one decode_step,
   whisper-small's encoder and one decode_step, in f32 within 1e-4 of the
   largest tp = 1 value; whisper-small's encoder in bf16 on the flash
   kernel at a rank's 6 heads (12 launches a rank), frames at cosine >=
   0.999 of tp = 1's. Phase 2 also holds both kernels at a tp
   rank's shapes (flash over H16 Hkv4 and H8 Hkv2 at S = T = 1024, over
   whisper-small's encoder at H6 and H3, S = T = 1500 non-causal, the f32
   kernel over H16 Hkv4; int4 at
   every tp = 2 and tp = 4 local projection and head shape at M = 1 and
   1024).
18. train (run after 17, over the same weights; no kernel runs, and the
   counts must not move): one sgd_train_step (parallel/train.py) at
   Llama-3.2-1B's full width and depth in f32 (the tied head a leaf of its
   own), B 4 x S 256 with a ragged mask, TF32 off: its ms and peak GB, its
   loss within 1e-5 (relative) and each leaf's gradient within 1e-4 of its
   largest |g| of the same step in f64 on the card. Then 8 ranks on the
   card: the step at dp 2 x tp 4 over the first 2 layers, its loss within
   1e-5 of one process's and its updated params, gathered whole, within
   1e-7 (lr x 1e-4), with the step's seconds and the bytes its collectives
   moved; and in the same ranks the dry run's phases 1-4
   (parallel/dryrun.py), then its product phase on 4 ranks, printing
   dryrun_multichip's line and loss.

19. zoo: the registry's other decoders at the widths of their public
   config.json (ZOO: Qwen2.5-0.5B-Instruct and -1.5B-Instruct at full depth,
   Llama-3.2-3B-Instruct, Phi-3.5-mini-instruct with seeded longrope factors,
   Mistral-7B-Instruct-v0.3 and Llama-3.1-8B-Instruct over their first 4
   layers; random bf16 weights from a seed, Qwen2's q/k/v biases, Phi-3's
   fused qkv_proj / gate_up_proj), each through run_slice in bf16 and in
   int4: phase 3's three requests (a 700-word prompt at bucket 1024, a
   follow-up adding 600 words over the cache, flash at the q_offset / kv_len
   phase 2 holds, and a 600-word stream), 32 greedy tokens each, no profile,
   held as phases 3 and 4 hold Llama-1B. Qwen2.5-0.5B also
   in f32 (the f32 flash kernel at G = 7, logits within 1e-4 of the
   largest) and through one ContinuousEngine pass of 8 requests with every
   admission wave on flash. Planted faults that must read outside the logits
   bound: Qwen2.5-0.5B's k/v rolled by one KV head in its flash calls and
   its q/k/v biases dropped, Phi-3.5-mini's long rope factors where the
   short ones apply. Then whisper-large-v3 (its 32 encoder layers, its
   decoder's first 4; 128 mel bins; its own special ids) through
   Transcriber: the encoder on flash (32 launches per encode) against the
   plain encoder (cosine >= 0.999; the causal call fails it), a 30 s
   translate whose prompt holds large-v3's ids and whose tokens lie in the
   tie band, and language detection over all 100 of its languages. One
   line per model: prefill ms, time to first token, decode tok/s, peak GB,
   each check's reading beside its bound, launches.

After each of phases 3-19 a line gives its own launches (the counts are set
to 0 just before it and read just after; 10 and 11 must launch no int4, 12
and 13 nothing, 18 nothing). At
the end come three lines: a JSON object {"kernels": [...]} (per kernel the
launches of phases 3-19,
max_abs_err over its cases, and ms / plain_ms / bound_ms / library_ms -- for
flash and f32 flash one launch at the Llama-1B prefill shape, for int4 the
113 launches of one decoded token, with its f32-output max_abs_err and
time beside; also printed before it: the 7 launches of one layer at
each M), then
"total <seconds>", then the card's name and power limit as nvidia-smi gives
them. bound_ms is the larger of the bytes moved over 3.35 TB/s and the
operations over their peak: 989 TFLOP/s bf16 on the tensor cores; for the
f32 kernel three TF32 products per operation at 495 TFLOP/s (its 3xTF32
design), with the 66.9 TFLOP/s f32 FFMA bound beside it as bound_ms_ffma
(H100 SXM data sheet). The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import gc
import importlib
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# f32 outside the tensor cores: 132 SMs x 128 FFMA x 2 x 1.98 GHz (H100 SXM);
# the f32 flash kernel's earlier FFMA design is bound by it
F32_FLOP_PER_S = 66.9e12
# dense TF32 on the tensor cores (H100 SXM data sheet); the f32 flash kernel's
# 3xTF32 design does three TF32 products per f32 one, so its bound is the f32
# work at a third of this rate
TF32_FLOP_PER_S = 495e12
ROOT = Path(__file__).resolve().parent

# Llama-3.2-1B's public config.json values
LLAMA_1B = {
    "model_type": "llama", "architectures": ["LlamaForCausalLM"],
    "vocab_size": 128256, "hidden_size": 2048, "intermediate_size": 8192,
    "num_hidden_layers": 16, "num_attention_heads": 32, "num_key_value_heads": 8,
    "head_dim": 64, "max_position_embeddings": 131072, "rope_theta": 500000.0,
    "rope_scaling": {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    "rms_norm_eps": 1e-5, "tie_word_embeddings": True,
    "bos_token_id": 128000, "eos_token_id": 128001, "torch_dtype": "bfloat16",
}


def int4_per_forward(layers: int) -> int:
    """int4 launches of one decoder forward: q, k, v, o, gate, up and down
    in each layer, then the head."""
    return 7 * layers + 1


# The registry's other decoders (kjarni_tpu_torch/registry.py), each with the
# values of its public config.json (the keys the loader reads); phase 19
# writes them at full width with random weights, the depth cut where ZOO says
QWEN25_05B = {   # Qwen/Qwen2.5-0.5B-Instruct
    "model_type": "qwen2", "architectures": ["Qwen2ForCausalLM"], "vocab_size": 151936,
    "hidden_size": 896, "intermediate_size": 4864, "num_hidden_layers": 24,
    "num_attention_heads": 14, "num_key_value_heads": 2, "max_position_embeddings": 32768,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-6, "tie_word_embeddings": True,
    "use_sliding_window": False, "sliding_window": 32768, "max_window_layers": 21,
    "bos_token_id": 151643, "eos_token_id": 151645, "torch_dtype": "bfloat16",
}
QWEN25_15B = {   # Qwen/Qwen2.5-1.5B-Instruct
    **QWEN25_05B, "hidden_size": 1536, "intermediate_size": 8960, "num_hidden_layers": 28,
    "num_attention_heads": 12, "max_window_layers": 21,
}
LLAMA32_3B = {   # meta-llama/Llama-3.2-3B-Instruct
    **LLAMA_1B, "hidden_size": 3072, "intermediate_size": 8192, "num_hidden_layers": 28,
    "num_attention_heads": 24, "num_key_value_heads": 8, "head_dim": 128,
    "eos_token_id": [128001, 128008, 128009],
}


def _longrope_factors(seed: int, n: int = 48) -> dict:
    """Seeded stand-ins for Phi-3.5-mini's longrope factor lists, NOT the
    published values (those are not in the repo): 48 entries each (D / 2),
    nondecreasing from 1 with the frequency index as the published ones are,
    the short ones up to ~2, the long ones up to ~60."""
    import numpy as np
    u = np.sort(np.random.default_rng(seed).uniform(0.0, 1.0, (2, n)), axis=1)
    return {"short_factor": [round(1.0 + float(x) ** 4, 4) for x in u[0]],
            "long_factor": [round(1.0 + 59.0 * float(x), 4) for x in u[1]]}


PHI35_MINI = {   # microsoft/Phi-3.5-mini-instruct (longrope factors seeded: see above)
    "model_type": "phi3", "architectures": ["Phi3ForCausalLM"], "vocab_size": 32064,
    "hidden_size": 3072, "intermediate_size": 8192, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 32,
    "max_position_embeddings": 131072, "original_max_position_embeddings": 4096,
    "rope_theta": 10000.0, "rope_scaling": {"type": "longrope", **_longrope_factors(35)},
    "rms_norm_eps": 1e-5, "sliding_window": 262144, "tie_word_embeddings": False,
    "bos_token_id": 1, "eos_token_id": 32000, "pad_token_id": 32000,
    "torch_dtype": "bfloat16",
}
MISTRAL_7B = {   # mistralai/Mistral-7B-Instruct-v0.3
    "model_type": "mistral", "architectures": ["MistralForCausalLM"], "vocab_size": 32768,
    "hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128,
    "max_position_embeddings": 32768, "rope_theta": 1000000.0, "rms_norm_eps": 1e-5,
    "sliding_window": None, "tie_word_embeddings": False, "bos_token_id": 1,
    "eos_token_id": 2, "torch_dtype": "bfloat16",
}
LLAMA31_8B = {   # meta-llama/Llama-3.1-8B-Instruct
    **LLAMA_1B, "hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128,
    "rope_scaling": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    "tie_word_embeddings": False, "eos_token_id": [128001, 128008, 128009],
}
# (registry name, public source, config, layers in phase 19): every width as
# published; the two Qwens at full depth, the others cut to their first 4
# layers to keep the phase's time and the card's memory
ZOO = (
    ("qwen2.5-0.5b-instruct", "Qwen/Qwen2.5-0.5B-Instruct", QWEN25_05B, 24),
    ("qwen2.5-1.5b", "Qwen/Qwen2.5-1.5B-Instruct", QWEN25_15B, 28),
    ("llama3.2-3b-instruct", "meta-llama/Llama-3.2-3B-Instruct", LLAMA32_3B, 4),
    ("phi3.5-mini", "microsoft/Phi-3.5-mini-instruct", PHI35_MINI, 4),
    ("mistral-7b", "mistralai/Mistral-7B-Instruct-v0.3", MISTRAL_7B, 4),
    ("llama3.1-8b-instruct", "meta-llama/Llama-3.1-8B-Instruct", LLAMA31_8B, 4),
)
ZOO_PROMPT_WORDS = 700      # the first request's prompt: bucket 1024
ZOO_NEW_TOKENS = 32
ZOO_BIAS_STD = 0.5          # Qwen2's q/k/v biases (tests/test_torch_llama.py's qwen2)


def heads(c: dict) -> tuple[int, int, int]:
    """(H, Hkv, D) of a decoder config."""
    H = c["num_attention_heads"]
    return H, c.get("num_key_value_heads", H), c.get("head_dim") or c["hidden_size"] // H


def zoo_reuse_offset(c: dict) -> int:
    """The follow-up request's cached prefix in phase 19: the prompt (BOS
    first for llama and mistral, as DecoderLM.encode_prompt adds it) and the
    first request's new tokens."""
    bos = c["model_type"] in ("llama", "mistral")
    return ZOO_PROMPT_WORDS + bos + ZOO_NEW_TOKENS


def zoo_flash_shapes() -> list:
    """(name, H, Hkv, D, q_offset) of each distinct flash shape of phase 19's
    decoders: their prefill at S = T = 1024 and their follow-up's cache reuse
    (S 1024 at q_offset over a kv bucket of 1792)."""
    out, seen = [], set()
    for name, _, c, _ in ZOO:
        H, Hkv, D = heads(c)
        key = (H, Hkv, D, zoo_reuse_offset(c))
        if key not in seen:
            seen.add(key)
            out.append((name, *key))
    return out
# the phases over the Llama-3.2-1B-width weights (3-9 and 14), between the
# launch counts' reset and their reading
GENERATION = ("bf16", "int4", "int8", "batch", "chat", "gpt2", "serve", "infra", "f32",
              "surfaces", "parallel", "train")
# the encoder-decoder phases (10 and 11), also on the main path
ENC_DEC = ("seq2seq", "whisper")

# the public config.json values (the keys the loader reads) of the registry's
# encoder models; all four use bert-base-uncased's 30,522-token vocabulary
MINILM_L6 = {
    "model_type": "bert", "architectures": ["BertModel"], "vocab_size": 30522,
    "hidden_size": 384, "num_hidden_layers": 6, "num_attention_heads": 12,
    "intermediate_size": 1536, "hidden_act": "gelu", "max_position_embeddings": 512,
    "type_vocab_size": 2, "layer_norm_eps": 1e-12, "pad_token_id": 0,
}
MINILM_CROSS = {**MINILM_L6, "architectures": ["BertForSequenceClassification"],
                "id2label": {"0": "LABEL_0"}, "label2id": {"LABEL_0": 0}}
DISTILBERT_SST2 = {
    "model_type": "distilbert", "architectures": ["DistilBertForSequenceClassification"],
    "vocab_size": 30522, "dim": 768, "n_layers": 6, "n_heads": 12, "hidden_dim": 3072,
    "activation": "gelu", "max_position_embeddings": 512, "pad_token_id": 0,
    "finetuning_task": "sst-2", "id2label": {"0": "NEGATIVE", "1": "POSITIVE"},
    "label2id": {"NEGATIVE": 0, "POSITIVE": 1},
}
NOMIC_V15 = {
    "model_type": "nomic_bert", "architectures": ["NomicBertModel"], "vocab_size": 30528,
    "n_embd": 768, "n_layer": 12, "n_head": 12, "n_inner": 3072, "n_positions": 8192,
    "rotary_emb_base": 1000, "rotary_emb_fraction": 1.0, "activation_function": "swiglu",
    "layer_norm_epsilon": 1e-12, "type_vocab_size": 2, "qkv_proj_bias": False,
    "mlp_fc1_bias": False, "mlp_fc2_bias": False, "prenorm": False,
}
# (registry name, public source, config, task API)
ENCODERS = (
    ("minilm-l6-v2", "sentence-transformers/all-MiniLM-L6-v2", MINILM_L6, "embed"),
    ("minilm-l6-v2-cross-encoder", "cross-encoder/ms-marco-MiniLM-L-6-v2", MINILM_CROSS,
     "rerank"),
    ("distilbert-sentiment", "distilbert/distilbert-base-uncased-finetuned-sst-2-english",
     DISTILBERT_SST2, "classify"),
    ("nomic-embed-text", "nomic-ai/nomic-embed-text-v1.5", NOMIC_V15, "embed"),
)
BERT_VOCAB = 30522
EMBED_BATCH, EMBED_SEQ = 256, 64        # bench.py's embed geometry
EMBED_COS_MIN = 0.999                   # BASELINE.json's parity bound
CLASSIFY_PROB_ATOL = 2e-2
RERANK_ATOL = 2e-2                      # on the raw relevance logits


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int = 20) -> float:
    """Device milliseconds per call of `fn`: `iters` calls captured in one
    CUDA graph, timed with events over its replays, so the host's launch
    cost (ctypes, allocation, Python) does not count."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    replays = 3
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def host_ms(fn, iters: int = 20) -> float:
    """Wall milliseconds per eager call, synchronised: what one call costs
    the host loop, launch overhead included."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def bound_ms(nbytes: float, flops: float,
             flop_rate: float = BF16_FLOP_PER_S) -> tuple[float, str]:
    """The least time the card could take, and what sets it: the bytes moved
    over the memory rate or the operations over their peak rate (bf16 on the
    tensor cores unless `flop_rate` says otherwise)."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_env() -> None:
    import torch
    from kjarni_tpu_torch.ops.kernels import build
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"compute mode: {compute_mode()}")
    # the C ABI embeds CPython: g++, python3-config and Python.h must be there
    from kjarni_tpu_torch.ffi import build as ffi_build
    import shutil
    inc, _ = ffi_build.embed_flags()
    header = next((Path(f[2:]) / "Python.h" for f in inc
                   if (Path(f[2:]) / "Python.h").exists()), None)
    print(f"python-config {ffi_build.python_config()} Python.h {header} "
          f"g++ {shutil.which('g++')} gcc {shutil.which('gcc')}")
    check(header is not None and shutil.which("g++") and shutil.which("gcc"),
          "python3-config, Python.h, g++ and gcc for the C ABI")
    for mod in ("tokenizers", "regex", "ml_dtypes", "safetensors", "triton"):
        try:
            importlib.import_module(mod)
            found = "imports"
        except ImportError:
            found = "missing"
        print(f"package {mod}: {found}")
    t0 = time.perf_counter()
    secs = build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s wall "
          + " ".join(f"{k}={v:.2f}s" for k, v in secs.items()))
    for name in build.KERNELS:
        log = build.library_path(name).with_suffix(".log")
        entry = ""
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:   # the kernel and its template values
                m = re.search(r"\d((?:flash|int4)_[a-z0-9_]+?_kernel(?:_sm90)?)(?:I(.*?)EEv)?",
                              line)
                entry = (m.group(1) + (f"<{','.join(re.findall(r'L[ib](\d+)', m.group(2)))}>"
                                       if m.group(2) else "")
                         if m else line.split("'")[1][:60])
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {entry or name}: {line.strip().replace('ptxas info    : ', '')}")
            elif "serialized" in line:   # ptxas ran a kernel's wgmma one at a time
                print(f"  ptxas {name}: {line.strip()[:160]}")
    # what each library runs on: its SASS's warpgroup (HGMMA) and warp (HMMA)
    # tensor-core instructions by operand type
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    for name in build.KERNELS:
        sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path(name))],
                              capture_output=True, text=True, timeout=120).stdout
        ops = {}
        for op in re.findall(r"\b(H[G]?MMA\.[0-9A-Za-z.]+)", sass):
            ops[op] = ops.get(op, 0) + 1
        print(f"  sass {name}: " + (", ".join(f"{k} x{v}" for k, v in sorted(ops.items()))
                                     or "no tensor-core instruction"))


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def _attended_pairs(S, T, causal, window, q_offset, kv_len) -> int:
    """(query, key) pairs the masks keep, per head."""
    n = 0
    for s in range(S):
        pos = q_offset + s
        hi = min(kv_len, T, pos + 1 if causal else T)
        lo = max(0, pos - window + 1) if window else 0
        n += max(0, hi - lo)
    return n


def _device_kernel(fn) -> str:
    """The name of the device kernel that takes the most time in one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    if not ev:
        return "not traced"

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0.0)
    return max(ev, key=dev_us).key[:90]


def flash_case(name, B, H, Hkv, S, T, D, causal=True, window=None, q_offset=0,
               kv_len=None, poison=False, seed=0, cache_len=None, ref_tol=None,
               controls=None, f32=False) -> dict:
    """One flash case against the plain version, within 3e-2 or, given
    ref_tol, within ref_tol * max|plain output|; two calls must give
    bit-identical outputs. cache_len: K/V are the first T slots of a
    [B, Hkv, cache_len, D] cache, and the line also times the materialized
    attention of _run_stack over the whole cache. controls: name -> keyword
    overrides of a wrong kernel call, each of which must fall outside the
    bound; a callable control is called instead of the kernel, with the
    case's keywords. f32: f32 inputs (the f32 kernel; its bound_ms counts
    4-byte elements and three TF32 products per operation at the tensor
    cores' TF32 rate, the 3xTF32 design, and bound_ms_ffma the f32 FFMA
    rate, the FFMA design), else bf16."""
    import torch
    import torch.nn.functional as F
    from kjarni_tpu_torch.ops.kernels import flash_attention as fa
    from kjarni_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    if D not in getattr(fa, "HEAD_DIMS", ()):
        print(json.dumps({"case": f"flash {name}", "skipped":
                          f"this checkout's kernel takes D in {fa.HEAD_DIMS}"}))
        return None
    if f32 and not hasattr(flash_attention, "launches_f32"):
        print(json.dumps({"case": f"flash {name}", "skipped":
                          "this checkout's kernel takes bf16 only"}))
        return None
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev, bf = "cuda", (torch.float32 if f32 else torch.bfloat16)
    counter = "launches_f32" if f32 else "launches"
    q = torch.randn(B, H, S, D, generator=g, device=dev).to(bf)
    kc = torch.randn(B, Hkv, cache_len or T, D, generator=g, device=dev).to(bf)
    vc = torch.randn(B, Hkv, cache_len or T, D, generator=g, device=dev).to(bf)
    k, v = kc[:, :, :T], vc[:, :, :T]
    kv = T if kv_len is None else kv_len
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    launches0 = getattr(flash_attention, counter)
    ref = flash_attention_plain(q, k, v, **kw)
    if poison:   # garbage past kv_len must not change the output
        k[:, :, kv:] = 1e3
        v[:, :, kv:] = -1e3
    out = flash_attention(q, k, v, **kw)
    again = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"flash {name}: finite output")
    check(out.dtype == bf, f"flash {name}: output dtype {out.dtype}")
    check(torch.equal(out, again), f"flash {name}: two calls give bit-identical outputs")
    err = (out.float() - ref.float()).abs().max().item()
    tol = 3e-2 if ref_tol is None else ref_tol * ref.float().abs().max().item()
    check(err <= tol, f"flash {name}: max_abs_err {err} <= {tol}")
    launches = getattr(flash_attention, counter) - launches0
    control_errs = {}
    for control, over in (controls or {}).items():
        bad = over(q, k, v, **kw) if callable(over) else flash_attention(q, k, v,
                                                                         **{**kw, **over})
        control_errs[control] = (bad.float() - ref.float()).abs().max().item()
        check(control_errs[control] > tol, f"flash {name}: control {control} reads "
                                           f"{control_errs[control]}, outside {tol}")
    setattr(flash_attention, counter, launches0 + launches)
    kernel_ms = cuda_ms(lambda: flash_attention(q, k, v, **kw))
    eager_ms = host_ms(lambda: flash_attention(q, k, v, **kw))
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, **kw), iters=5)
    materialized_ms = None
    if cache_len:   # _run_stack without flash: attention over the whole cache
        from kjarni_tpu_torch.ops.attention import NEG_INF, attention
        qi = q_offset + torch.arange(S, device=dev)[:, None]
        kj = torch.arange(cache_len, device=dev)[None, :]
        bias = torch.where(kj <= qi, 0.0, NEG_INF)[None, None]
        mat = attention(q, kc, vc, bias)
        e = (mat.float() - ref.float()).abs().max().item()
        check(e <= 3e-2, f"flash {name}: materialized max_abs_err {e} <= 3e-2")
        materialized_ms = cuda_ms(lambda: attention(q, kc, vc, bias), iters=5)
    # the library yardstick: SDPA on K/V repeated to H heads (outside the
    # timing), with is_causal, or with the same mask as a boolean tensor
    kr = k.repeat_interleave(H // Hkv, dim=1)
    vr = v.repeat_interleave(H // Hkv, dim=1)
    if window is None and q_offset == 0 and kv_len is None and (S == T or not causal):
        def sdpa():   # no mask tensor: is_causal, or none at all
            return F.scaled_dot_product_attention(q, kr, vr, is_causal=causal)
    else:
        row = q_offset + torch.arange(S, device=dev)[:, None]
        col = torch.arange(T, device=dev)[None, :]
        mask = (col < kv) & (col <= row if causal else True)
        if window:
            mask = mask & (col > row - window)

        def sdpa():
            return F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask)
    library_ms = cuda_ms(sdpa)
    library_kernel = _device_kernel(sdpa)
    pairs = _attended_pairs(S, T, causal, window, q_offset, kv)
    nbytes = q.element_size() * (2 * B * H * S * D + 2 * B * Hkv * min(kv, T) * D)
    flops = 4 * D * pairs * B * H
    if f32:
        bound, bound_by = bound_ms(nbytes, 3 * flops, TF32_FLOP_PER_S)
    else:
        bound, bound_by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
    row = {"case": f"flash {name}", "launches": getattr(flash_attention, counter) - launches0,
           "max_abs_err": err, "bound": tol, "kernel_ms": kernel_ms,
           "eager_ms": eager_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library_kernel": library_kernel, "bound_ms": bound, "bound_by": bound_by}
    if f32:
        row["bound_ms_ffma"], row["bound_by_ffma"] = bound_ms(nbytes, flops, F32_FLOP_PER_S)
    if materialized_ms is not None:
        row["materialized_ms"] = materialized_ms
    if control_errs:
        row["control_max_abs_err"] = control_errs
    print(json.dumps(row))
    return row


def _int4_weights(K, N, G, seed):
    import torch
    from kjarni_tpu_torch.models.llama import _quant_int4
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(K, N, generator=g, device="cuda") * 0.02
    return _quant_int4(w, K // G)


def _close_to_plain(name, out, ref) -> tuple[float, float]:
    """The int4 check: allclose rtol/atol 2e-2 and cosine > 0.999."""
    import torch
    err = (out.float() - ref.float()).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(
        out.float().reshape(-1), ref.float().reshape(-1), dim=0).item()
    check(bool(torch.allclose(out.float(), ref.float(), rtol=2e-2, atol=2e-2)),
          f"{name}: allclose rtol/atol 2e-2 (max_abs_err {err})")
    check(cos > 0.999, f"{name}: cosine {cos} > 0.999")
    return err, cos


def _tinygemm_weights(w4, scale):
    """(packed weight, qScaleAndZeros, group size) for torch._weight_int4pack_mm
    holding the same function as (w4, scale), or a string saying why the shape
    cannot be expressed. The signed nibble s becomes s + 8 in [0, 15], in the
    original K order; the scale is rounded to bf16 and the zero is 0, so
    tinygemm's (q - 8) * scale + zero is s * scale."""
    import torch
    from kjarni_tpu_torch.ops.kernels.int4_matvec import unpack_int4
    K2, N = w4.shape
    K, G = 2 * K2, scale.shape[0]
    if G == 1 or K // G not in (32, 64, 128, 256):
        return f"tinygemm takes groups of 32-256 rows, not {K // G} (G = {G})"
    if N % 8 or K % 128:
        return f"tinygemm needs N % 8 == 0 and K % 128 == 0 (K {K}, N {N})"
    lo, hi = unpack_int4(w4)
    q = (torch.cat([lo, hi]) + 8).t().contiguous().to(torch.uint8)   # [N, K]
    packed = (q[:, ::2] << 4 | q[:, 1::2]).contiguous()              # [N, K/2]
    wp = torch._convert_weight_to_int4pack(packed, 8)
    sz = torch.stack([scale.to(torch.bfloat16),
                      torch.zeros_like(scale, dtype=torch.bfloat16)], -1).contiguous()
    return wp, sz, K // G


# int4 with f32 activations against the plain version in its form
# (x_as_bf16): both round x to bf16 and sum f32 products in f32, so they
# differ only in the order of their sums. Held to this share of the plain
# output's largest magnitude; the same output stored through bf16 (the round
# trip the f32 output exists to avoid, ~0.4% of a value) must fall outside.
INT4_F32_REF_TOL = 1e-5


def _int4_f32_close(tag, out, ref) -> dict:
    """The f32-output int4 check: within INT4_F32_REF_TOL of the largest
    plain output, and the planted control (out rounded through bf16) not."""
    import torch
    tol = INT4_F32_REF_TOL * ref.abs().max().item()
    err = (out - ref).abs().max().item()
    control = (out.to(torch.bfloat16).float() - ref).abs().max().item()
    check(out.dtype == torch.float32 and err <= tol,
          f"{tag}: {out.dtype} output within {tol} of the plain version (max_abs_err {err})")
    check(control > tol, f"{tag}: the output stored through bf16 falls outside {tol} "
                         f"(control error {control})")
    return {"max_abs_err": err, "tol": tol, "bf16_store_control_err": control}


# (M, K, N) where tinygemm's own rounding misses the int4 check's elementwise
# allclose (on the H100: max error 0.044 at M = 1024, K = 14,336, 0.048 at
# M = 4096, where ours passes); there int4_case holds the library to the same function instead:
# max error within 2e-2 of the largest plain output, cosine > 0.999
TINYGEMM_ALLCLOSE_MISSES = {(1024, 14336, 4096), (4096, 14336, 4096), (8192, 14336, 4096)}


def int4_case(name, M, K, N, seed=0, f32=False) -> dict:
    """One int4 case against the plain version, bit-identical on a repeat,
    timed beside its bound and tinygemm. f32: f32 activations, which the
    kernel rounds to bf16 before writing f32, held to the plain version in
    that form (x_as_bf16) by _int4_f32_close; no GEMM beside the GEMV, and no
    library time (tinygemm takes bf16 x alone)."""
    import functools
    import torch
    from kjarni_tpu_torch.ops.kernels import int4_matvec as i4
    from kjarni_tpu_torch.ops.kernels.int4_matvec import int4_matvec, int4_matvec_plain
    tag = f"int4 f32 {name}" if f32 else f"int4 {name}"
    G = K // 128
    w4, scale = _int4_weights(K, N, G, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.randn(M, K, generator=g, device="cuda")
    if not f32:
        x = x.to(torch.bfloat16)
    launches0 = int4_matvec.launches
    # the plain version on the same bf16 inputs, evaluated in f32: in bf16 it
    # rounds each half's product before adding the two, up to a bf16 ulp of
    # the halves, which atol 2e-2 does not cover at K = 8192
    plain = functools.partial(int4_matvec_plain, x_as_bf16=True) if f32 else int4_matvec_plain
    ref = plain(x, w4, scale) if f32 else int4_matvec_plain(x.float(), w4, scale)
    out = int4_matvec(x, w4, scale)
    again = int4_matvec(x, w4, scale)
    torch.cuda.synchronize()
    check(out.dtype == x.dtype, f"{tag}: output dtype {out.dtype}")
    err, cos = _close_to_plain(tag, out, ref)
    tight = _int4_f32_close(tag, out, ref) if f32 else {}
    check(torch.equal(out, again), f"{tag}: two calls give bit-identical outputs")
    launches = int4_matvec.launches - launches0
    # at M = 1, the GEMM beside the GEMV that the plan picks (not in an older
    # checkout, whose wrapper has no gemm_plan); where the plan takes the
    # wgmma GEMM, the mma.sync GEMM beside it (mma_sync_ms)
    path = i4.launch_plan(M, K, N, scale.shape[0]).path
    gemm = mma_sync = None
    if M == 1 and hasattr(i4, "gemm_plan") and not f32:
        plan = i4.gemm_plan(M, K, N)

        def gemm(a, w, s):
            return i4._launch(a, w, s, plan)
        _close_to_plain(f"int4 {name} gemm", gemm(x, w4, scale), ref)
    if path == "wgmma":
        old_plan = i4.gemm_plan(M, K, N)

        def mma_sync(a, w, s):
            return i4._launch(a, w, s, old_plan)
        _close_to_plain(f"int4 {name} mma.sync gemm", mma_sync(x, w4, scale), ref)
    # the library yardstick, checked like the kernel before it is timed,
    # except where its own rounding was measured to miss the elementwise
    # allclose (TINYGEMM_ALLCLOSE_MISSES): there it is held to computing the
    # same function; both readings are kept
    tg = "tinygemm takes bf16 x" if f32 else _tinygemm_weights(w4, scale)
    lib_check = None
    if isinstance(tg, str):
        print(f"{tag}: library_ms null: {tg}")
    else:
        lib = torch._weight_int4pack_mm(x, tg[0], tg[2], tg[1])
        torch.cuda.synchronize()
        top = ref.float().abs().max().item()
        lib_check = {"max_abs_err": (lib.float() - ref.float()).abs().max().item(),
                     "cosine": _cosine(lib, ref), "allclose_2e-2": bool(
                         torch.allclose(lib.float(), ref.float(), rtol=2e-2, atol=2e-2))}
        lib_check["err_share_of_max"] = lib_check["max_abs_err"] / top
        if (M, K, N) in TINYGEMM_ALLCLOSE_MISSES:
            check(lib_check["err_share_of_max"] <= 2e-2 and lib_check["cosine"] > 0.999,
                  f"tinygemm {name}: max_abs_err {lib_check['max_abs_err']} within 2e-2 "
                  f"of the largest output {top}, cosine {lib_check['cosine']} > 0.999")
        else:
            _close_to_plain(f"tinygemm {name}", lib, ref)
    # decode and short prefills find their weights cold: cycle through copies
    # filling > 2x L2; M = 1024 is bound by its operations and cycles through two
    wbytes = w4.numel() + scale.numel() * 4
    nbytes = (M * K + M * N) * x.element_size() + wbytes
    copies = max(1, min(64, math.ceil(100e6 / wbytes))) if M <= 128 else 2
    ws = [(w4.clone(), scale.clone()) for _ in range(copies)]
    it = [0]

    def cycle(fn, weights):
        def step():
            w, s = weights[it[0] % copies]
            it[0] += 1
            fn(x, w, s)
        return step

    iters = max(20, copies)
    kernel_ms = cuda_ms(cycle(int4_matvec, ws), iters=iters)
    eager_ms = host_ms(cycle(int4_matvec, ws), iters=iters)
    plain_ms = cuda_ms(cycle(plain, ws), iters=10)
    gemm_ms = None if gemm is None else cuda_ms(cycle(gemm, ws), iters=iters)
    mma_sync_ms = None if mma_sync is None else cuda_ms(cycle(mma_sync, ws), iters=iters)
    library_ms = None
    if not isinstance(tg, str):
        wp, sz, gs = tg
        del ws
        libs = [(wp.clone(), sz.clone()) for _ in range(copies)]
        library_ms = cuda_ms(cycle(lambda a, w, s: torch._weight_int4pack_mm(a, w, gs, s),
                                   libs), iters=iters)
        del libs
    bound, bound_by = bound_ms(nbytes, 2 * M * K * N)
    row = {"case": tag, "path": path, "launches": launches,
           "max_abs_err": err, "cosine": cos,
           "kernel_ms": kernel_ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound, "bound_by": bound_by,
           "tb_per_s": 1e-9 * nbytes / kernel_ms}
    if lib_check is not None:
        row["library_check"] = lib_check
    if tight:
        row["f32_tol"] = tight["tol"]
        row["bf16_store_control_err"] = tight["bf16_store_control_err"]
    if gemm_ms is not None:
        row["gemm_ms"] = gemm_ms
    if mma_sync_ms is not None:
        row["mma_sync_ms"] = mma_sync_ms
    print(json.dumps(row))
    return row


def phase_flash() -> list:
    B, H, Hkv, D = 1, 32, 8, 64
    flash = [
        flash_case("llama1b-prefill S=T=1024", B, H, Hkv, 1024, 1024, D),
        flash_case("D=128 gqa", 1, 16, 4, 512, 512, 128, seed=1),
        flash_case("D=32 gqa", 2, 8, 2, 256, 256, 32, seed=2),
        flash_case("unaligned S=T=700", B, H, Hkv, 700, 700, D, seed=3),
        flash_case("window=64", 1, 8, 2, 512, 512, D, window=64, seed=4),
        flash_case("q_offset=200 kv_len=328 poisoned", B, H, Hkv, 128, 512, D,
                   q_offset=200, kv_len=328, poison=True, seed=5),
        # Phi-3.5-mini's prefill (hidden 3072 / 32 heads, no GQA)
        flash_case("phi3.5-mini-prefill S=T=1024 D=96", B, 32, 32, 1024, 1024, 96,
                   seed=6),
        # the smallest from-zero flash bucket
        flash_case("llama1b-prefill S=T=512", B, H, Hkv, 512, 512, D, seed=7),
        # the follow-up request: a 1024 bucket reusing 765 cached slots, over
        # kv_bucket 1792 of the 4096-slot cache
        flash_case("llama1b-reuse S=1024 q_offset=765 kv_len=1789 T=1792", B, H, Hkv,
                   1024, 1792, D, q_offset=765, kv_len=1789, poison=True, seed=8,
                   cache_len=4096),
        # the smallest cache-reuse flash prefill: a 512 bucket over the
        # 16-token minimum reused prefix
        flash_case("llama1b-reuse S=512 q_offset=16 kv_len=528 T=640", B, H, Hkv,
                   512, 640, D, q_offset=16, kv_len=528, poison=True, seed=9,
                   cache_len=4096),
        # the continuous engine's flash admission wave: 8 lanes of a 2048
        # bucket after a 256-token shared prefix, over their 2304-slot
        # working caches
        flash_case("llama1b-admission B=8 S=2048 q_offset=256 T=2304", 8, H, Hkv,
                   2048, 2304, D, q_offset=256, kv_len=2304, seed=10),
        # whisper-small's encoder self-attention (non-causal, 12 heads, 1,500
        # frames: 23 full 64-key tiles and a ragged one of 28): one serial
        # chunk, and the 240 s input's wave of 8 chunks. Each output averages
        # ~550 value rows (|out| ~0.03, the largest under 1), so 3e-2 is the
        # size of an output: these are held to 1.5% of the largest (two to
        # three bf16 ulps there), and a causal call and one that drops the
        # last key must fall outside that
        flash_case("whisper-encoder B=1 H=12 S=T=1500 non-causal", 1, 12, 12, 1500, 1500,
                   D, causal=False, seed=11, ref_tol=WHISPER_FLASH_REF_TOL,
                   controls=WHISPER_FLASH_CONTROLS),
        flash_case("whisper-encoder B=8 H=12 S=T=1500 non-causal", 8, 12, 12, 1500, 1500,
                   D, causal=False, seed=12, ref_tol=WHISPER_FLASH_REF_TOL,
                   controls=WHISPER_FLASH_CONTROLS),
        *zoo_flash_cases(flash_case, seed=100),
    ]
    return [r for r in flash if r is not None]


def zoo_flash_cases(case, seed: int) -> list:
    """`case` (flash_case or flash_f32_case) at phase 19's shapes: each
    decoder's prefill at S = T = 1024 (Phi-3.5-mini's is phase 2's own case)
    and its follow-up's cache reuse (S 1024 at the cached prefix's q_offset,
    over the 1792-slot kv bucket of the 4096-slot cache, the tail past kv_len
    poisoned), then whisper-large-v3's encoder (H20, S = T = 1500, non-causal,
    held as whisper-small's)."""
    rows = []
    for i, (name, H, Hkv, D, off) in enumerate(zoo_flash_shapes()):
        G = f"G={H // Hkv}"
        if name != "phi3.5-mini":
            rows.append(case(f"{name}-prefill H{H} Hkv{Hkv} {G} S=T=1024 D={D}", 1, H, Hkv,
                             1024, 1024, D, seed=seed + 2 * i))
        rows.append(case(f"{name}-reuse H{H} Hkv{Hkv} {G} S=1024 q_offset={off} "
                         f"kv_len={off + 1024} T=1792 D={D}", 1, H, Hkv, 1024, 1792, D,
                         q_offset=off, kv_len=off + 1024, poison=True, cache_len=4096,
                         seed=seed + 2 * i + 1))
    Hw = WHISPER_LARGE_V3["encoder_attention_heads"]
    whisper = dict(ref_tol=WHISPER_FLASH_REF_TOL, controls=WHISPER_FLASH_CONTROLS) \
        if case is flash_case else {}
    rows.append(case(f"whisper-large-v3-encoder B=1 H={Hw} S=T=1500 non-causal", 1, Hw, Hw,
                     1500, 1500, 64, causal=False, seed=seed + 20, **whisper))
    return rows


FLASH_F32_REF_TOL = 1e-5     # of the plain output's largest magnitude


def flash_f32_case(name, B, H, Hkv, S, T, D, **kw) -> dict:
    """flash_case in f32, held to FLASH_F32_REF_TOL of the largest plain
    output; a call that drops the last key it attends, and the kernel with
    its split's small terms dropped (TF32 only, where the checkout has that
    control), must fall outside."""
    from kjarni_tpu_torch.ops.kernels import flash_attention as fa
    kv = kw.get("kv_len") or T
    controls = {"last key dropped": {"kv_len": kv - 1}}
    if hasattr(fa, "flash_attention_f32_tf32only"):
        controls["TF32 only"] = fa.flash_attention_f32_tf32only
    return flash_case(f"f32 {name}", B, H, Hkv, S, T, D, f32=True,
                      ref_tol=FLASH_F32_REF_TOL, controls=controls, **kw)


def phase_flash_f32() -> list:
    """The f32 kernel at the f32 generation path's shapes: the Llama-1B
    prefill and the follow-up's cache reuse, Phi-3.5-mini's D = 96, a window,
    the other two head dims, and whisper-small's encoder shape."""
    B, H, Hkv, D = 1, 32, 8, 64
    flash = [
        flash_f32_case("llama1b-prefill S=T=1024", B, H, Hkv, 1024, 1024, D, seed=20),
        flash_f32_case("llama1b-reuse S=1024 q_offset=765 kv_len=1789 T=1792", B, H, Hkv,
                       1024, 1792, D, q_offset=765, kv_len=1789, poison=True, seed=21,
                       cache_len=4096),
        flash_f32_case("phi3.5-mini-prefill S=T=1024 D=96", B, 32, 32, 1024, 1024, 96,
                       seed=22),
        flash_f32_case("window=64", 1, 8, 2, 512, 512, D, window=64, seed=23),
        flash_f32_case("D=128 gqa", 1, 16, 4, 512, 512, 128, seed=24),
        flash_f32_case("D=32 gqa", 2, 8, 2, 256, 256, 32, seed=25),
        # off the path: the f32 Transcriber's encoder runs plain attention
        # (flash is its bf16 form's); the shape is checked and timed all the same
        flash_f32_case("whisper-encoder B=1 H=12 S=T=1500 non-causal", 1, 12, 12, 1500,
                       1500, D, causal=False, seed=26),
        # phase 19's shapes; f32 runs on its path for Qwen2.5-0.5B (G = 7)
        # alone, the rest and whisper-large-v3's encoder are held here
        *zoo_flash_cases(flash_f32_case, seed=130),
    ]
    return [r for r in flash if r is not None]


def phase_int4_f32(shapes: dict, per_token: dict) -> dict:
    """int4_case with f32 activations at M = 1 (every projection and the
    head: one decoded token's 113 launches in f32), M = 8 and M = 1024 (the
    layer's four projection shapes)."""
    layer = [n for n in shapes if n != "lm_head 2048x128256"]
    rows = {f"M=1 {n}": int4_case(f"M=1 {n}", 1, *shapes[n], seed=40 + i, f32=True)
            for i, n in enumerate(shapes)}
    for M in (8, 1024):
        rows.update({f"M={M} {n}": int4_case(f"M={M} {n}", M, *shapes[n], seed=50 + i,
                                             f32=True)
                     for i, n in enumerate(layer)})
    tok = {key: sum(per_token[n] * rows[f"M=1 {n}"][key] for n in shapes)
           for key in ("kernel_ms", "plain_ms", "bound_ms")}
    tok.update(_x_cast_cost(shapes, per_token))
    print(json.dumps({"case": "int4 f32 one decoded token (113 launches)", **tok}))
    return {"rows": list(rows.values()), "token": tok}


def _int4_cast_then_kernel(x, w4, scale, plan):
    """x rounded to bf16 by torch, then int4's bf16-x, f32-output entry
    point with `plan`: the form that the GEMV's own f32 load replaced."""
    import ctypes
    import torch
    from kjarni_tpu_torch.ops.kernels import build
    xb = x.to(torch.bfloat16)
    M, K = x.shape
    N, G = w4.shape[1], scale.shape[0]
    y = torch.empty(M, N, dtype=torch.float32, device=x.device)
    lib = build.load("int4_matvec")
    fn = lib.kj_int4_matvec_bf16_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(xb.data_ptr(), w4.data_ptr(), scale.data_ptr(), y.data_ptr(), None, None,
             M, K, N, G, 0, plan.col_threads, plan.rows_per_lane, plan.row_tile,
             plan.splits, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "int4_matvec")
    return y


def _x_cast_cost(shapes: dict, per_token: dict) -> dict:
    """What the GEMV's own rounding of an f32 x removed from one decoded
    token (113 int4 launches at M = 1): the parent's form (x.to(bfloat16),
    then the bf16-x f32-output entry point, _int4_cast_then_kernel) against
    the one call that takes
    f32 x, each checked bit-identical to the other first; device ms
    (graph-timed, over weight copies filling > 2x L2 as in int4_case) and
    eager ms on the host, summed over the token. An older checkout (--root),
    whose wrapper casts, reports the cast alone."""
    import torch
    from kjarni_tpu_torch.ops.kernels import int4_matvec as i4
    if not hasattr(i4, "_ENTRIES"):
        xs = {n: torch.randn(1, K, device="cuda") for n, (K, _) in shapes.items()}
        dev = sum(per_token[n] * cuda_ms(lambda x=x: x.to(torch.bfloat16))
                  for n, x in xs.items())
        eager = sum(per_token[n] * host_ms(lambda x=x: x.to(torch.bfloat16), iters=200)
                    for n, x in xs.items())
        return {"x_cast_ms": dev, "x_cast_eager_ms": eager}
    keys = ("parent_form_ms", "fused_ms", "parent_form_eager_ms", "fused_eager_ms")
    out = dict.fromkeys(keys, 0.0)
    for i, (n, (K, N)) in enumerate(shapes.items()):
        w4, scale = _int4_weights(K, N, K // 128, seed=60 + i)
        g = torch.Generator(device="cuda").manual_seed(70 + i)
        x = torch.randn(1, K, generator=g, device="cuda")
        plan = i4.launch_plan(1, K, N, K // 128)
        copies = max(1, min(64, math.ceil(100e6 / (w4.numel() + scale.numel() * 4))))
        ws = [(w4.clone(), scale.clone()) for _ in range(copies)]
        it = [0]

        def parent():
            w, s = ws[it[0] % copies]
            it[0] += 1
            return _int4_cast_then_kernel(x, w, s, plan)

        def fused():
            w, s = ws[it[0] % copies]
            it[0] += 1
            return i4.int4_matvec(x, w, s)
        it[0] = 0
        a = parent()
        it[0] = 0
        check(torch.equal(a, fused()), f"int4 f32 M=1 {n}: one call bit-identical to "
                                       f"the cast and the bf16-x kernel")
        iters = max(20, copies)
        for key, fn in (("parent_form", parent), ("fused", fused)):
            out[f"{key}_ms"] += per_token[n] * cuda_ms(fn, iters=iters)
            out[f"{key}_eager_ms"] += per_token[n] * host_ms(fn, iters=max(200, copies))
        del ws
    out["removed_ms"] = out["parent_form_ms"] - out["fused_ms"]
    out["removed_eager_ms"] = out["parent_form_eager_ms"] - out["fused_eager_ms"]
    return out


def phase_kernels() -> dict:
    flash = phase_flash()
    flash_f32 = phase_flash_f32()
    shapes = {"q/o 2048x2048": (2048, 2048), "k/v 2048x512": (2048, 512),
              "gate/up 2048x8192": (2048, 8192), "down 8192x2048": (8192, 2048),
              "lm_head 2048x128256": (2048, 128256)}
    per_token = {"q/o 2048x2048": 32, "k/v 2048x512": 32, "gate/up 2048x8192": 32,
                 "down 8192x2048": 16, "lm_head 2048x128256": 1}
    int4 = {name: int4_case(f"M=1 {name}", 1, K, N, seed=i)
            for i, (name, (K, N)) in enumerate(shapes.items())}
    layer = [n for n in shapes if n != "lm_head 2048x128256"]
    # prefill buckets: short prompts and prefix-reuse suffixes (8-128), the
    # batch phase's 64-token shared prefix, long prompts (1024), and a
    # batched prefill of 8 rows at bucket 1024 (8192); M = 8 is also a
    # batched decode step of 8 rows and the continuous engine's decode step
    # of 8 slots; M = 5 is the speculative target pass (k = 4), 256 the
    # engine's system prompt and 256 and 512 its single-lane admission
    # waves, and 16,384 its admission wave of 8 lanes at bucket 2048
    prefill = {M: {name: int4_case(f"M={M} {name}", M, *shapes[name], seed=9 + i)
                   for i, name in enumerate(layer)}
               for M in (5, 8, 32, 64, 128, 256, 512, 1024, 8192, 16384)}
    # the head of the batch prefill and of each batched decode step: 8 rows
    head8 = int4_case("M=8 lm_head 2048x128256", 8, *shapes["lm_head 2048x128256"],
                      seed=20)

    def total(rows, counts, what):
        keys = ["kernel_ms", "eager_ms", "plain_ms", "bound_ms"]
        keys += [k for k in ("gemm_ms", "mma_sync_ms") if all(k in r for r in rows.values())]
        out = {key: sum(counts[n] * rows[n][key] for n in rows) for key in keys}
        libs = [rows[n]["library_ms"] for n in rows]
        out["library_ms"] = (None if None in libs else
                             sum(counts[n] * rows[n]["library_ms"] for n in rows))
        out["bound_by"] = ("bytes" if all(rows[n]["bound_by"] == "bytes" for n in rows)
                           else "operations")
        print(json.dumps({"case": what, **out}))
        return out

    tok = total(int4, per_token, "int4 one decoded token (113 launches)")
    check(tok["bound_by"] == "bytes", "int4 M=1 bound by bytes")
    per_layer = {n: per_token[n] // LLAMA_1B["num_hidden_layers"] for n in layer}
    for M, rows in prefill.items():
        total(rows, per_layer, f"int4 one layer at M = {M} (7 launches)")
    total({**prefill[8], "lm_head 2048x128256": head8}, per_token,
          "int4 one batched decode step of 8 rows (113 launches)")
    int4_f32 = phase_int4_f32(shapes, per_token)
    tp = phase_tp_kernels(total, per_token)
    zoo = phase_zoo_kernels(total)
    return {"flash": flash + tp["flash"], "flash_f32": flash_f32 + tp["flash_f32"],
            "int4_f32": int4_f32,
            "int4": list(int4.values()) + [head8] + [r for rows in prefill.values()
                                                     for r in rows.values()] + tp["int4"]
            + zoo, "int4_token": tok}


# the launches of each int4 shape per layer (zoo_int4_shapes); one for the head
ZOO_INT4_PER_LAYER = {"q": 1, "k/v": 2, "o": 1, "gate/up": 2, "down": 1}


def zoo_int4_shapes(c: dict) -> dict:
    """name -> (K, N) of each int4 launch of a decoder of config c: the
    layer's projections (Phi-3's fused qkv and gate_up split as llama.py
    splits them) and the head."""
    hid, inter = c["hidden_size"], c["intermediate_size"]
    H, Hkv, D = heads(c)
    return {"q": (hid, H * D), "k/v": (hid, Hkv * D), "o": (H * D, hid),
            "gate/up": (hid, inter), "down": (inter, hid), "lm_head": (hid, c["vocab_size"])}


def phase_zoo_kernels(total) -> list:
    """int4 at phase 19's shapes, against the plain version as every int4
    case: each decoder's projections and head at M = 1, summed over a
    decoded token at the model's published depth (7 x layers + 1 launches),
    and its projections at M = 1024 (one layer of the 1024-token prefill, 7
    launches), Mistral-7B's also at M = 4096 and 8192. A shape that two decoders share runs once. int4_case's
    groups of 128 fall back to one scale per column where K / 256 is not
    whole (Qwen2.5-0.5B's K = 896: G = 1), as quantize_params_int4 does."""
    done = {}

    def case(M, K, N):
        if (M, K, N) not in done:
            done[M, K, N] = int4_case(f"zoo M={M} {K}x{N}", M, K, N, seed=(7 * K + N) % 997 + M)
        return done[M, K, N]
    for name, _, c, _ in ZOO:
        shapes, L = zoo_int4_shapes(c), c["num_hidden_layers"]
        per_token = {**{n: k * L for n, k in ZOO_INT4_PER_LAYER.items()}, "lm_head": 1}
        total({n: case(1, K, N) for n, (K, N) in shapes.items()}, per_token,
              f"int4 one decoded token of {name} ({int4_per_forward(L)} launches)")
        for M in (1024, 4096, 8192) if name == "mistral-7b" else (1024,):
            total({n: case(M, K, N) for n, (K, N) in shapes.items() if n != "lm_head"},
                  ZOO_INT4_PER_LAYER, f"int4 one layer of {name} at M = {M} (7 launches)")
    return list(done.values())


# each projection's and the head's (K, N) on one rank of the tp decoder at
# Llama-3.2-1B's widths: q, k, v, gate, up and the head column-parallel (N/tp),
# o and down row-parallel (K/tp)
def tp_shapes(tp: int) -> dict:
    c = LLAMA_1B
    hid, inter, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    q, kv = c["num_attention_heads"] * c["head_dim"], c["num_key_value_heads"] * c["head_dim"]
    return {"q": (hid, q // tp), "k/v": (hid, kv // tp), "o": (q // tp, hid),
            "gate/up": (hid, inter // tp), "down": (inter // tp, hid),
            "lm_head": (hid, V // tp)}


def phase_tp_kernels(total, per_token: dict) -> dict:
    """Both kernels at the shapes one rank of the tp decoder launches (the
    parallel phase), against their plain versions with the same bounds:
    flash over a rank's heads at the 1024 prefill (H16 Hkv4 at tp = 2, H8
    Hkv2 at tp = 4) and at whisper-small's encoder (H6 at tp = 2, H3 at
    tp = 4, S = T = 1500, non-causal), int4 at every local shape at M = 1 (decode) and M = 1024
    (the prefill), with a rank's decoded token summed (113 launches)."""
    c = LLAMA_1B
    H, Hkv, D = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    flash = [flash_case(f"tp={tp} rank prefill H{H // tp} Hkv{Hkv // tp} S=T=1024",
                        1, H // tp, Hkv // tp, 1024, 1024, D, seed=60 + tp)
             for tp in (2, 4)]
    # whisper-small's encoder on a tp rank (phase 17's tp = 2 encoder; H3 at
    # tp = 4), non-causal, held as phase 2 holds the full-width shape
    Hw = WHISPER_SMALL["encoder_attention_heads"]
    flash += [flash_case(f"tp={tp} rank whisper-encoder H{Hw // tp} S=T=1500 non-causal",
                         1, Hw // tp, Hw // tp, 1500, 1500, D, causal=False, seed=64 + tp,
                         ref_tol=WHISPER_FLASH_REF_TOL, controls=WHISPER_FLASH_CONTROLS)
              for tp in (2, 4)]
    # phase 17's f32 tp = 2 prefill
    flash_f32 = [flash_f32_case(f"tp=2 rank prefill H{H // 2} Hkv{Hkv // 2} S=T=1024",
                                1, H // 2, Hkv // 2, 1024, 1024, D, seed=66)]
    counts = {"q": 16, "k/v": 32, "o": 16, "gate/up": 32, "down": 16, "lm_head": 1}
    check(sum(counts.values()) == sum(per_token.values()), "a rank's token: 113 launches")
    int4 = []
    for tp in (2, 4):
        for M in (1, 1024):
            rows = {n: int4_case(f"tp={tp} M={M} {n} {K}x{N}", M, K, N, seed=70 + i)
                    for i, (n, (K, N)) in enumerate(tp_shapes(tp).items())}
            int4 += rows.values()
            if M == 1:
                total(rows, counts, f"int4 one decoded token on a tp={tp} rank (113 launches)")
    return {"flash": flash, "flash_f32": flash_f32, "int4": int4}


# ---------------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------------

def layers_view(d: Path, dst: Path, n: int) -> Path:
    """Model dir d cut to its first n layers: d's config with n layers
    beside links to d's weights and tokenizer files."""
    dst.mkdir(exist_ok=True)
    c = json.loads((d / "config.json").read_text())
    (dst / "config.json").write_text(json.dumps({**c, "num_hidden_layers": n}))
    for f in ("model.safetensors", "tokenizer.json", "generation_config.json"):
        if (d / f).exists():
            (dst / f).symlink_to(d / f)
    return dst


def write_model_dir(d: Path, seed: int = 0, c: dict = LLAMA_1B) -> None:
    """config.json + model.safetensors of random bf16 weights for llama-family
    config c, generated on the card from a seeded generator (N(0, 0.02);
    norms are ones), under the names models/llama.py reads: Qwen2's q/k/v
    biases (N(0, ZOO_BIAS_STD), drawn after a layer's weights) and Phi-3's
    fused qkv_proj and gate_up_proj (the same draws concatenated)."""
    import torch
    from kjarni_tpu_torch.weights.safetensors_loader import save_file
    hid, inter, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    H, Hkv, D = heads(c)
    qd, kvd = H * D, Hkv * D
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, std=0.02):
        return (torch.randn(*shape, generator=g, device="cuda") * std
                ).to(torch.bfloat16).cpu()

    ones = torch.ones(hid, dtype=torch.bfloat16)
    tensors = {"model.embed_tokens.weight": rnd(V, hid), "model.norm.weight": ones}
    if not c["tie_word_embeddings"]:
        tensors["lm_head.weight"] = rnd(V, hid)
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        w = {"q_proj": rnd(qd, hid), "k_proj": rnd(kvd, hid), "v_proj": rnd(kvd, hid),
             "o_proj": rnd(hid, qd), "gate_proj": rnd(inter, hid),
             "up_proj": rnd(inter, hid), "down_proj": rnd(hid, inter)}
        if c["model_type"] == "phi3":
            tensors.update({
                p + "self_attn.qkv_proj.weight": torch.cat([w.pop(n) for n in
                                                            ("q_proj", "k_proj", "v_proj")]),
                p + "mlp.gate_up_proj.weight": torch.cat([w.pop("gate_proj"),
                                                          w.pop("up_proj")])})
        tensors.update({p + ("mlp." if n.endswith(("gate_proj", "up_proj", "down_proj"))
                             else "self_attn.") + n + ".weight": t for n, t in w.items()})
        if c["model_type"] == "qwen2":
            tensors.update({p + f"self_attn.{n}.bias": rnd(width, std=ZOO_BIAS_STD)
                            for n, width in (("q_proj", qd), ("k_proj", kvd),
                                             ("v_proj", kvd))})
        tensors.update({p + "input_layernorm.weight": ones,
                        p + "post_attention_layernorm.weight": ones})
    d.mkdir(parents=True, exist_ok=True)
    save_file(tensors, d / "model.safetensors")
    (d / "config.json").write_text(json.dumps(c))


def write_tokenizer(path: Path, vocab_size: int, specials: dict | None = None) -> None:
    """A word-level tokenizer.json over the whole vocabulary: [PAD], [UNK]
    and the words w0, w1, ... (whitespace split), so every id decodes.
    `specials` {text: id} puts special tokens at those ids (in place of
    their words), split out of the text before the words."""
    from tokenizers import AddedToken, Tokenizer, models, normalizers, pre_tokenizers
    words = ["[PAD]", "[UNK]"] + [f"w{i}" for i in range(vocab_size - 2)]
    for text, i in (specials or {}).items():
        words[i] = text
    tk = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)},
                                    unk_token="[UNK]"))
    tk.normalizer = normalizers.Lowercase()
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    if specials:
        tk.add_special_tokens([AddedToken(t, special=True, normalized=False)
                               for t in specials])
    tk.save(str(path))


def _prompt(n: int, seed: int, hi: int = 120000) -> str:
    """n random words of the tokenizer's vocabulary (ids 1000..hi)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return " ".join(f"w{i - 2}" for i in
                    torch.randint(1000, hi, (n,), generator=g).tolist())


def prefill_logits(lm, ids: list, params=None, dtype=None, device="cuda"):
    """Logits [1, V] (f32) of one from-zero prefill of `ids`, padded to its
    seq bucket, over a fresh cache: the forward a single-stream request
    runs first (flash where the model takes it, at a bucket >= 512)."""
    import torch
    from kjarni_tpu_torch.core.bucketing import seq_bucket
    bucket = seq_bucket(len(ids), lm.max_context)
    x = torch.zeros(1, bucket, dtype=torch.long, device=device)
    x[0, :len(ids)] = torch.tensor(ids, device=device)
    # an older checkout (--root) has the llama family alone
    family = getattr(lm, "family", None) or importlib.import_module(
        "kjarni_tpu_torch.models.llama")
    ck, cv = family.init_cache(lm.config, 1, bucket, dtype or lm._cache_dtype, device)
    with torch.inference_mode():
        return family.forward(
            lm.params if params is None else params, lm.config, x, ck, cv, 0,
            len(ids) - 1, use_flash=lm._flash_ok and bucket >= lm._flash_min_seq
        )[0].float()


def _cosine(a, b) -> float:
    import torch
    return torch.nn.functional.cosine_similarity(
        a.float().reshape(-1), b.float().reshape(-1).to(a.device), dim=0).item()


def f32_params(p: dict) -> dict:
    """f32 copies of a param dict's float tensors (int8/int4 stay)."""
    return {k: f32_params(v) if isinstance(v, dict) else
            (v.float() if v.is_floating_point() else v) for k, v in p.items()}


@contextlib.contextmanager
def plain_kernels(x_as_bf16: bool = False):
    """Within the block the llama forward runs both kernels' plain versions
    (for f32 forwards, and as the reference the kernels are held to).
    x_as_bf16: int4's plain version in the kernel's form for f32 x (x rounded
    to bf16, f32 out), the reference of f32 on the card."""
    import functools
    from kjarni_tpu_torch.models import llama as kllama
    from kjarni_tpu_torch.ops.kernels import flash_attention as fa
    from kjarni_tpu_torch.ops.kernels import int4_matvec as i4
    saved = kllama.flash_attention, kllama.int4_matvec
    kllama.flash_attention, kllama.int4_matvec = (
        fa.flash_attention_plain,
        functools.partial(i4.int4_matvec_plain, x_as_bf16=True) if x_as_bf16
        else i4.int4_matvec_plain)
    try:
        yield
    finally:
        kllama.flash_attention, kllama.int4_matvec = saved


def _logits_vs_plain(lm, text: str, faults: dict | None = None) -> tuple[dict, object]:
    """The first prefill's logits through the kernels vs the same forward
    with the kernels' plain versions, on the card, both in bf16; and both
    against that forward in f32 (plain versions, f32 copies of the params).
    faults: name -> a context manager factory fault(lm) planting a fault in
    the kernels' forward, whose logits must fall outside the f32 bound that
    the sound forward keeps. Returns the stats and the kernels' logits."""
    import torch
    ids = lm.encode_prompt(text)

    def fwd(params, dtype):
        return prefill_logits(lm, ids, params, dtype)

    counts = _counts()
    got = fwd(lm.params, lm._cache_dtype)
    # one call's wall time moves with the shared host: take the median of 5
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd(lm.params, lm._cache_dtype)
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0))
    # comparison launches are not the main path's: restore the counts
    _restore(counts)
    with plain_kernels():
        ref = fwd(lm.params, lm._cache_dtype)
        ref32 = fwd(f32_params(lm.params), torch.float32)
    torch.cuda.empty_cache()

    def cmp(a, b):
        err = (a - b).abs().max().item()
        return (err, err / b.abs().max().item(),
                torch.nn.functional.cosine_similarity(a, b).item())

    err, rel, cos = cmp(got, ref)
    err32, _, cos32 = cmp(got, ref32)
    plain32, _, _ = cmp(ref, ref32)
    check(bool(torch.isfinite(got).all()), "prefill logits finite")
    check(got.shape == (1, lm.config.vocab_size), f"logits shape {got.shape}")
    planted = {}
    for name, fault in (faults or {}).items():
        counts = _all_counts()
        with fault(lm):
            bad = fwd(lm.params, lm._cache_dtype)
        _restore(counts)
        bad_err32, _, bad_cos = cmp(bad, ref32)
        planted[name] = {"vs_f32_max_abs_err": bad_err32, "bound": 2 * plain32,
                         "cosine_vs_f32": bad_cos}
        check(bad_err32 > 2 * plain32, f"planted fault {name}: vs f32 {bad_err32} falls "
                                       f"outside the bound 2 x plain bf16 {2 * plain32}")
    # bf16 rounds in other places on the two paths (the flash kernel's bf16
    # probabilities; the int4 plain version's bf16 dequantized weights, which
    # the kernel never forms) and 16 residual layers carry that forward. So
    # the f32 forward decides: the kernels may be no further from it than
    # twice the plain bf16 path is. The cosine against the plain path only
    # catches a gross fault (a wrong tile or mask drops it far below 0.995).
    check(cos > 0.995, f"prefill logits vs plain: cosine {cos} > 0.995")
    check(err32 <= 2 * plain32, f"prefill logits vs f32: kernels {err32} <= "
                                f"2 x plain bf16 {plain32}")
    stats = {"logits_max_abs_err": err, "logits_rel_err": rel, "logits_cosine": cos,
             "kernels_vs_f32_max_abs_err": err32, "kernels_vs_f32_cosine": cos32,
             "plain_bf16_vs_f32_max_abs_err": plain32,
             "prefill_ms_1024": statistics.median(runs), "prefill_ms_1024_runs": runs}
    if planted:
        stats["faults"] = planted
    return stats, got.cpu()


def profile_request(gen, text: str, new_tokens: int = 16) -> dict:
    """profile_call over one streamed request (prefill + `new_tokens` decode
    steps)."""
    from kjarni_tpu_torch.generate.sampling import GenerationConfig
    cfg = GenerationConfig.greedy(max_new_tokens=new_tokens, max_length=4096)

    def request():
        for _ in gen.generate_stream(text, config=cfg):
            pass
    return profile_call(request)


def profile_call(fn, top: int = 8, ops: bool = True) -> dict:
    """torch.profiler over one call of `fn`: device busy share of the wall
    time, the `top` kernels that take the most device time, and (`ops`) the
    torch ops (with input shapes) that launch the most device time; sorting
    the ops of a call of ~10^4 kernels takes the profiler ~30 s."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=ops) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0.0)

    def on_device(e):
        return str(e.device_type).endswith("CUDA")

    kernels = [e for e in p.key_averages() if on_device(e) and dev_us(e) > 0]
    total = sum(dev_us(e) for e in kernels)
    top_kernels = sorted(kernels, key=dev_us, reverse=True)[:top]

    def op_dev_us(e):   # device time of the kernels an op launched itself
        return getattr(e, "device_time_total", None) or \
            getattr(e, "cuda_time_total", 0.0)

    aten = [e for e in p.key_averages(group_by_input_shape=True)
            if not on_device(e) and e.key.startswith("aten::") and op_dev_us(e) > 0] \
        if ops else []
    top_ops = sorted(aten, key=op_dev_us, reverse=True)[:top]
    return {"profile_wall_ms": wall_us / 1e3, "profile_kernel_ms": total / 1e3,
            "profile_device_busy": total / wall_us,
            "profile_top_kernels": [[e.key[:70], round(dev_us(e) / 1e3, 3), e.count]
                                    for e in top_kernels],
            "profile_top_ops": [[e.key, str(e.input_shapes)[:90],
                                 round(op_dev_us(e) / 1e3, 3), e.count]
                                for e in top_ops]}


def run_slice(model_dir: Path, quantize=None, dtype: str = "auto", new_tokens: int = 64,
              faults: tuple = (), engine: bool = False, profile: bool = True) -> dict:
    """Three requests through Generator (see the module docstring, phases 3
    and 19), checked and timed; prints one line per request and a summary
    line. The model's depth and vocabulary come from its config. dtype="f32":
    the first prefill's logits held by _f32_logits_vs_plain; new_tokens: the
    generate and follow-up requests' greedy tokens; faults: zoo_fault names
    that must read outside the logits bound; engine: then one ContinuousEngine
    pass (zoo_engine); profile: a profiled request. Returns the summary, with
    the first prefill's logits ("logits", not printed; None in f32) and the
    follow-up's prompt and generated ids ("follow_ids", "follow_out")."""
    import torch
    from kjarni_tpu_torch import Generator
    from kjarni_tpu_torch.models import decoder_lm
    from kjarni_tpu_torch.models import llama as kllama
    from kjarni_tpu_torch.generate.sampling import GenerationConfig
    f32 = dtype == "f32"
    tag = " ".join(filter(None, ["f32" if f32 else None, quantize])) or "bf16"
    t0 = time.perf_counter()
    gen = Generator(str(model_dir), quantize=quantize, dtype=dtype)
    lm = gen.lm
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(lm.device.type == "cuda" and lm._flash_ok, f"{tag}: model on the card, flash on")
    L = lm.config.num_layers
    hi = min(120000, lm.config.vocab_size)
    a, b = _prompt(700, 1, hi), _prompt(600, 2, hi)
    if f32:
        stats, logits = _f32_logits_vs_plain(lm, a, tag), None
    else:
        stats, logits = _logits_vs_plain(lm, a, {f: functools.partial(zoo_fault, name=f)
                                                 for f in faults})
        if quantize == "int4":
            stats.update(_int4_teacher_forced(lm, lm.encode_prompt(a), tag))
    torch.cuda.reset_peak_memory_stats()

    def request(name, fn, text, expect_flash, shape):
        """fn(text) with its launches counted (expect_flash on the dtype's
        flash kernel, each call of (S, T, q_offset, kv_len) `shape`; under
        int4 int4_per_forward per forward) and its greedy tokens held within
        SERVE_TIE_BAND of a teacher-forced plain forward."""
        c0, shapes, real = _all_counts(), [], kllama.flash_attention

        def spy(q, k, v, **kw):
            shapes.append((q.shape[2], k.shape[2], kw.get("q_offset", 0), kw.get("kv_len")))
            return real(q, k, v, **kw)
        n_before = len(lm._session_ids)
        ids = lm.encode_prompt(text)
        kllama.flash_attention = spy
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            fn(text)
        finally:
            kllama.flash_attention = real
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        out_ids = lm._session_ids[len(ids):]
        flash_n, int4_n, f32_n = (x - y for x, y in zip(_all_counts(), c0))
        want = (0, expect_flash) if f32 else (expect_flash, 0)
        check((flash_n, f32_n) == want, f"{tag} {name}: (flash, f32 flash) launches "
                                        f"{(flash_n, f32_n)}, expected {want}")
        want4 = int4_per_forward(L) * (1 + len(out_ids)) if quantize == "int4" else 0
        check(int4_n == want4, f"{tag} {name}: {int4_n} int4 launches, expected {want4}")
        check(shapes == [shape] * expect_flash, f"{tag} {name}: flash calls {set(shapes)}, "
                                                f"expected {expect_flash} of {shape}")
        check(len(out_ids) > 0, f"{tag} {name}: generated tokens")
        P = len(ids)
        ref = _teacher_forced(lm, ids + out_ids, list(range(P - 1, P + len(out_ids) - 1)))
        margin = max(_margins(ref, out_ids))
        check(margin <= SERVE_TIE_BAND, f"{tag} {name}: greedy tokens within "
                                        f"{SERVE_TIE_BAND} of the teacher-forced maximum "
                                        f"({margin})")
        row = {"request": f"{tag} {name}", "prompt_tokens": P,
               "prefilled_tokens": lm.last_prefill_tokens,
               "new_tokens": len(out_ids), "seconds": secs,
               "tok_per_s": len(out_ids) / secs, "flash_launches": flash_n + f32_n,
               "int4_launches": int4_n, "session_before": n_before,
               "flash_shape": list(shape) if expect_flash else None,
               "max_margin": [margin, SERVE_TIE_BAND]}
        print(json.dumps(row))
        return row

    greedy = GenerationConfig.greedy(max_new_tokens=new_tokens, max_length=4096)
    out1 = {}

    def generate(text):
        out1["text"] = gen.generate(text, config=greedy)

    prefill = (1024, 1024, 0, None)
    r1 = request("generate 700", generate, a, L, prefill)
    follow = f"{a} {out1['text']} {_prompt(600, 3, hi)}"
    # a checkout without the measured gate keeps the follow-up off flash
    reuse_flash = hasattr(decoder_lm, "REUSE_FLASH_MIN_SCORE_BYTES")
    off = r1["prompt_tokens"] + r1["new_tokens"]
    r2 = request("follow-up reuse", generate, follow, L if reuse_flash else 0,
                 (1024, 1792, off, off + 1024))
    follow_ids = lm.encode_prompt(follow)
    follow_out = lm._session_ids[len(follow_ids):]
    check(r2["prefilled_tokens"] == r2["prompt_tokens"] - off,
          f"{tag}: the follow-up prefilled only its new suffix")
    stream_cfg = GenerationConfig.greedy(max_new_tokens=32, max_length=4096)
    first = {}

    def stream(text):
        n = 0
        for _ in gen.generate_stream(text, config=stream_cfg):
            if n == 0:
                torch.cuda.synchronize()
                first["t"] = time.perf_counter()
            n += 1
        torch.cuda.synchronize()
        first["decode_s"] = time.perf_counter() - first["t"]

    t_req = time.perf_counter()
    r3 = request("stream 600", stream, b, L, prefill)
    ttft_ms = 1e3 * (first["t"] - t_req)
    decode_tps = (r3["new_tokens"] - 1) / first["decode_s"]
    prof = profile_request(gen, _prompt(600, 4, hi)) if profile else {}
    summary = {"slice": tag, "load_s": load_s, **stats, **prof,
               "stream_ttft_ms": ttft_ms, "stream_decode_tok_per_s": decode_tps,
               "max_margin": [max(r["max_margin"][0] for r in (r1, r2, r3)), SERVE_TIE_BAND],
               "flash_launches": sum(r["flash_launches"] for r in (r1, r2, r3)),
               "int4_launches": sum(r["int4_launches"] for r in (r1, r2, r3)),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps(summary))
    if engine:
        summary["engine"] = zoo_engine(lm, tag)
    del gen, lm
    gc.collect()
    torch.cuda.empty_cache()
    return {**summary, "logits": logits, "follow_ids": follow_ids,
            "follow_out": follow_out, "reuse_offset": off}


def _counted(name: str, fn, *args):
    """Run one main-path phase with the launch counts set to 0 just before
    it and read just after; print them and add them to the counts so far."""
    before = _all_counts()
    _restore((0, 0, 0))
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        got = _all_counts()
        _restore(tuple(b + g for b, g in zip(before, got)))
        print(json.dumps({"phase": name, "seconds": time.perf_counter() - t0,
                          "flash_launches": got[0], "int4_launches": got[1],
                          "flash_f32_launches": got[2]}))


def phase_slices(phases) -> None:
    """Phases 3-9 and 14 over one Llama-3.2-1B-width model dir (and GPT-2's)."""
    with tempfile.TemporaryDirectory(prefix="kjarni_smoke_") as tmp:
        d = Path(tmp) / "llama-3.2-1b-random"
        t0 = time.perf_counter()
        write_model_dir(d)
        write_tokenizer(d / "tokenizer.json", LLAMA_1B["vocab_size"])
        print(f"model dir written: {time.perf_counter() - t0:.1f} s, "
              f"{(d / 'model.safetensors').stat().st_size / 1e9:.2f} GB")
        ran = {}
        if "bf16" in phases:
            ran["bf16"] = _counted("bf16", run_slice, d, None)
        if "int4" in phases:
            ran["int4"] = _counted("int4", run_slice, d, "int4")
        if "int8" in phases:
            _counted("int8", phase_int8, d, ran.get("bf16"))
        if "batch" in phases:
            _counted("batch", phase_batch, d, ran)
        if "chat" in phases:
            _counted("chat", phase_chat, d, Path(tmp) / "llama-3.2-1b-chat")
        if "gpt2" in phases:
            _counted("gpt2", phase_gpt2, Path(tmp) / "gpt2-random")
        if "serve" in phases:
            before = _counts()
            _counted("serve", phase_serve, d, Path(tmp))
            serve_n = [a - b for a, b in zip(_counts(), before)]
            check(serve_n[0] > 0 and serve_n[1] > 0,
                  f"the serve phase launched both kernels (flash, int4: {serve_n})")
        if "infra" in phases:
            _counted("infra", phase_infra, d, Path(tmp))
        if "f32" in phases:
            _counted("f32", phase_f32, d, Path(tmp), ran)
        if "surfaces" in phases:
            _counted("surfaces", phase_surfaces, d, Path(tmp))
        if "parallel" in phases:
            _counted("parallel", phase_parallel, d, Path(tmp))
        if "train" in phases:
            before = _all_counts()
            _counted("train", phase_train, d, Path(tmp))
            check(_all_counts() == before, "the train phase launched no kernel")


def _counts() -> tuple[int, int]:
    """(flash, int4) launches so far: the bf16 flash kernel's and int4's."""
    from kjarni_tpu_torch.ops.kernels.flash_attention import flash_attention
    from kjarni_tpu_torch.ops.kernels.int4_matvec import int4_matvec
    return flash_attention.launches, int4_matvec.launches


def _all_counts() -> tuple[int, int, int]:
    """(flash, int4, f32 flash) launches so far (an older checkout has no
    f32 kernel: 0)."""
    from kjarni_tpu_torch.ops.kernels.flash_attention import flash_attention
    return (*_counts(), getattr(flash_attention, "launches_f32", 0))


def _restore(counts: tuple) -> None:
    """Put the launch counts back: launches made to compare or to build a
    reference are not the main path's. A 3-tuple (_all_counts) puts back the
    f32 kernel's count too."""
    from kjarni_tpu_torch.ops.kernels.flash_attention import flash_attention
    from kjarni_tpu_torch.ops.kernels.int4_matvec import int4_matvec
    flash_attention.launches, int4_matvec.launches = counts[:2]
    if len(counts) > 2 and hasattr(flash_attention, "launches_f32"):
        flash_attention.launches_f32 = counts[2]


def _common_prefix(a: list, b: list) -> int:
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


# ---------------------------------------------------------------------------
# phase 5: int8 weights and the int8 KV cache
# ---------------------------------------------------------------------------

def int8_mm_case(name: str, M: int, K: int, N: int, seed: int) -> dict:
    """_mm's int8 branch ((x @ w.to(bf16)) * scale, one torch matmul and a
    bf16 copy of the weight per call) against x @ w in bf16, device ms per
    call, weights cycled through copies filling > 2x L2 as int4_case does."""
    import torch
    from kjarni_tpu_torch.models.llama import _mm, _quant_int8
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = (torch.randn(K, N, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    q, scale = _quant_int8(w)
    x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
    err = (_mm(x, {"w": q, "scale": scale}).float() - (x @ w).float()).abs().max().item()
    copies = max(1, min(32, math.ceil(100e6 / (K * N))))
    q8 = [({"w": q.clone(), "scale": scale.clone()}) for _ in range(copies)]
    bf = [w.clone() for _ in range(copies)]
    it = [0]

    def int8():
        it[0] += 1
        _mm(x, q8[it[0] % copies])

    def bf16():
        it[0] += 1
        return x @ bf[it[0] % copies]
    iters = max(20, copies)
    row = {"case": f"int8 {name}", "M": M, "K": K, "N": N,
           "int8_ms": cuda_ms(int8, iters=iters), "bf16_ms": cuda_ms(bf16, iters=iters),
           "int8_bound_ms": bound_ms(K * N + 4 * N + 2 * M * (K + N), 2 * M * K * N)[0],
           "max_abs_err_vs_bf16": err}
    print(json.dumps(row))
    del q8, bf
    torch.cuda.empty_cache()
    return row


def _layers_cut(lm, n: int):
    """A stand-in for lm with its first n layers alone (what prefill_logits
    reads of a DecoderLM)."""
    import types
    p = lm.params
    layers = {k: ({kk: t[:n] for kk, t in v.items()} if isinstance(v, dict) else v[:n])
              for k, v in p["layers"].items()}
    return types.SimpleNamespace(
        family=lm.family, config=dataclasses.replace(lm.config, num_layers=n),
        params={**p, "layers": layers}, max_context=lm.max_context,
        _cache_dtype=lm._cache_dtype, _flash_ok=lm._flash_ok,
        _flash_min_seq=lm._flash_min_seq)


def int8_accuracy(d: Path, text: str) -> dict:
    """The first prefill's logits with int8 weights against the bf16
    weights': on the path (bf16, kernels), and in f32 (f32 copies of both,
    the quantization's own effect as the JAX package computes it in f32),
    at full depth and over the first 2 layers.

    Checks: over 2 layers, the depth of the JAX test that set the bound
    (tests/test_generation.py, a 2-layer model), cosine >= 0.999. At full
    depth the quantization's own f32 cosine falls below 0.999 on these
    random weights (0.9968 on the H100, PERF.md), so the path is held to it
    as the kernels are held to the plain path: its distance from 1 at most
    twice that of the f32 quantization and the bf16 path's own rounding. A
    control must fall outside that margin: the same weights truncated
    toward zero instead of rounded (_quant_int8_truncated)."""
    import torch
    from kjarni_tpu_torch import Generator
    from kjarni_tpu_torch.models import llama as kllama
    counts = _counts()
    lm_b, lm_8 = Generator(str(d)).lm, Generator(str(d), quantize="int8").lm
    ids = lm_b.encode_prompt(text)
    f32 = f32_params
    out = {}
    for depth, (b, q) in {16: (lm_b, lm_8), 2: (_layers_cut(lm_b, 2), _layers_cut(lm_8, 2))
                          }.items():
        out[f"cos_int8_vs_bf16_weights_L{depth}"] = _cosine(prefill_logits(q, ids),
                                                           prefill_logits(b, ids))
        with plain_kernels():
            out[f"cos_int8_vs_bf16_weights_L{depth}_f32"] = _cosine(
                prefill_logits(q, ids, f32(q.params), torch.float32),
                prefill_logits(b, ids, f32(b.params), torch.float32))
            if depth == 16:
                out["cos_bf16_vs_f32_L16"] = _cosine(
                    prefill_logits(b, ids),
                    prefill_logits(b, ids, f32(b.params), torch.float32))
    # a control the full-depth margin must reject: the same int8 weights
    # truncated toward zero (a bare .to(torch.int8) cast) instead of rounded
    out["cos_int8_truncated_vs_bf16_weights_L16"] = _cosine(
        prefill_logits(lm_8, ids, kllama._quantize_params(lm_b.params, _quant_int8_truncated,
                                                          "w")),
        prefill_logits(lm_b, ids))
    _restore(counts)
    del lm_b, lm_8
    torch.cuda.empty_cache()
    allowed = 2 * ((1 - out["cos_int8_vs_bf16_weights_L16_f32"])
                   + (1 - out["cos_bf16_vs_f32_L16"]))
    print(json.dumps({"case": "int8 accuracy", **out, "allowed_1_minus_cosine_L16": allowed}))
    check(out["cos_int8_vs_bf16_weights_L2"] >= 0.999,
          f"int8 vs bf16 weights over 2 layers: cosine "
          f"{out['cos_int8_vs_bf16_weights_L2']} >= 0.999")
    check(1 - out["cos_int8_vs_bf16_weights_L16"] <= allowed,
          f"int8 vs bf16 weights at full depth: 1 - cosine "
          f"{1 - out['cos_int8_vs_bf16_weights_L16']} <= {allowed}")
    check(1 - out["cos_int8_truncated_vs_bf16_weights_L16"] > allowed,
          f"the truncated int8 control at full depth: 1 - cosine "
          f"{1 - out['cos_int8_truncated_vs_bf16_weights_L16']} > {allowed}")
    return out


def _quant_int8_truncated(w):
    """llama._quant_int8 with a fault: w / scale truncated toward zero."""
    import torch
    w32 = w.float()
    scale = w32.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.trunc(w32 / scale).to(torch.int8), scale.squeeze(-2)


def phase_int8(d: Path, bf16: dict | None) -> None:
    """run_slice with quantize="int8", held against the bf16 weights; the
    int8 matmul against bf16 per decoded token; one kv_cache="int8"
    follow-up against the bf16-KV one."""
    import torch
    from kjarni_tpu_torch import Generator
    from kjarni_tpu_torch.generate.sampling import GenerationConfig
    s8 = run_slice(d, "int8")
    acc = int8_accuracy(d, _prompt(700, 1))
    keys = ("prefill_ms_1024", "stream_decode_tok_per_s", "peak_mem_gb")
    print(json.dumps({"case": "int8 weights beside bf16", **acc,
                      **{f"int8_{k}": s8[k] for k in keys},
                      **{f"bf16_{k}": (bf16 or {}).get(k) for k in keys}}))

    shapes = {"q/o 2048x2048": (2048, 2048, 32), "k/v 2048x512": (2048, 512, 32),
              "gate/up 2048x8192": (2048, 8192, 32), "down 8192x2048": (8192, 2048, 16),
              "lm_head 2048x128256": (2048, 128256, 1)}
    rows = {n: int8_mm_case(f"M=1 {n}", 1, K, N, seed=40 + i)
            for i, (n, (K, N, _)) in enumerate(shapes.items())}
    print(json.dumps({"case": "int8 one decoded token (113 matmuls)", **{
        k: sum(shapes[n][2] * rows[n][k] for n in rows)
        for k in ("int8_ms", "bf16_ms", "int8_bound_ms")}}))

    # the follow-up over the int8 cache, after its own first request
    gen = Generator(str(d), quantize="int8", kv_cache="int8")
    lm = gen.lm
    check(lm._ensure_cache()[0]["q"].dtype == torch.int8, "int8 KV cache")
    greedy = GenerationConfig.greedy(max_new_tokens=64, max_length=4096)
    torch.cuda.reset_peak_memory_stats()
    lm.generate(token_ids=lm.encode_prompt(_prompt(700, 1)), config=greedy)
    common = _common_prefix(lm._session_ids, s8["follow_ids"])
    f0, i0 = _counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    lm.generate(token_ids=s8["follow_ids"], config=greedy)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    flash_n, int4_n = _counts()[0] - f0, _counts()[1] - i0
    out = lm._session_ids[len(s8["follow_ids"]):]
    check(flash_n == lm.config.num_layers, f"int8 KV follow-up: {flash_n} flash launches, "
                                           f"expected {lm.config.num_layers}")
    check(int4_n == 0, "int8 KV follow-up: no int4 launches")
    check(common >= 16 and lm.last_prefill_tokens == len(s8["follow_ids"]) - common,
          f"int8 KV follow-up prefilled only its suffix ({lm.last_prefill_tokens} of "
          f"{len(s8['follow_ids'])}, {common} cached)")
    ref = s8["follow_out"]
    agree = sum(a == b for a, b in zip(out, ref)) / max(len(ref), 1)
    print(json.dumps({"request": "int8 weights, int8 KV follow-up reuse",
                      "prompt_tokens": len(s8["follow_ids"]), "reused_tokens": common,
                      "prefilled_tokens": lm.last_prefill_tokens, "new_tokens": len(out),
                      "seconds": secs, "tok_per_s": len(out) / secs,
                      "flash_launches": flash_n,
                      "greedy_ids_agreeing_with_bf16_kv": agree,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    del gen, lm
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6: batched generation and sampled decoding
# ---------------------------------------------------------------------------

BATCH_PREFIX = 64       # a shared system prefix: BOS + 63 words
SAMPLING = dict(temperature=0.9, top_k=40, top_p=0.9, min_p=0.05)


def _batch_prompts(totals: list, seed: int, hi: int = 120000,
                   prefix_words: int = BATCH_PREFIX - 1) -> list:
    """Prompts of totals[r] tokens (with the llama BOS) that share a
    `prefix_words`-word prefix and then differ from their first word on."""
    prefix = _prompt(prefix_words, seed, hi)
    return [f"{prefix} w{9 + r} {_prompt(n - prefix_words - 2, seed + 1 + r, hi)}"
            for r, n in enumerate(totals)]


def _keep_mask(row, sp):
    """What the top-k, top-p and min-p filters keep of one row of logits
    (numpy f32 [V]), computed here in numpy apart from the port's torch code.
    Masked logits have probability 0 in the later filters, so each filter
    works over what the one before kept. The top-p and min-p cutoffs get
    1e-5 of slack for the other order of the sums on the card."""
    import numpy as np
    keep = np.ones(row.shape, dtype=bool)
    V = row.shape[0]
    if sp.top_k and sp.top_k < V:
        keep &= row >= np.partition(row, V - sp.top_k)[V - sp.top_k]
    if sp.top_p is not None:
        vals = np.sort(row[keep])[::-1]
        e = np.exp(vals - vals[0])
        probs = e / e.sum()
        kept = (np.cumsum(probs) - probs) <= sp.top_p + 1e-5
        keep &= row >= vals[kept].min()
    if sp.min_p is not None:
        idx = np.flatnonzero(keep)
        e = np.exp(row[idx] - row[idx].max())
        probs = e / e.sum()
        keep[idx[probs < probs.max() * sp.min_p * (1 - 1e-5)]] = False
    return keep


class DrawCheck:
    """Within the block, every sampled draw of DecoderLM (single-stream and
    batched) is checked to lie in its row's top-k / top-p / min-p set
    (_keep_mask over the same processed logits)."""

    def __init__(self):
        self.draws = 0

    def __enter__(self):
        from kjarni_tpu_torch.models import decoder_lm
        self._orig = orig = decoder_lm.sample_token

        def checked(logits, generator, params, greedy):
            tok = orig(logits, generator, params, greedy)
            if not greedy:
                lg = logits.float().reshape(-1, logits.shape[-1]).cpu().numpy()
                for r, v in enumerate(tok.reshape(-1).tolist()):
                    check(bool(_keep_mask(lg[r], params)[v]),
                          f"sampled token {v} lies in its row's top-k/top-p/min-p set")
                self.draws += tok.numel()
            return tok
        decoder_lm.sample_token = checked
        return self

    def __exit__(self, *exc):
        from kjarni_tpu_torch.models import decoder_lm
        decoder_lm.sample_token = self._orig


def run_batch(gen, prompts: list, cfg, tag: str) -> dict:
    """One Generator.generate_batch call, timed (prefill to its end, then
    decode) and checked: no flash (the padded batch takes the plain
    attention), and in int4 113 launches per forward."""
    import torch
    lm = gen.lm
    c0 = _counts()
    marks = {}
    prefill = lm._batch_prefill

    def timed(*args):
        out = prefill(*args)
        torch.cuda.synchronize()
        marks["prefill_end"] = time.perf_counter()
        return out
    lm._batch_prefill = timed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        texts = gen.generate_batch(prompts, config=cfg)
        torch.cuda.synchronize()
    finally:
        del lm._batch_prefill
    t1 = time.perf_counter()
    flash_n, int4_n = (a - b for a, b in zip(_counts(), c0))
    new = sum(len(t.split()) for t in texts)
    forwards = int(lm._batch_prefix_len > 0) + 1 + lm.last_batch_steps
    check(flash_n == 0, f"{tag}: no flash launches in the padded batch ({flash_n})")
    want = int4_per_forward(lm.config.num_layers) * forwards if "int4" in tag else 0
    check(int4_n == want, f"{tag}: {int4_n} int4 launches, expected {want}")
    check(new > 0, f"{tag}: generated tokens")
    row = {"batch": tag, "B": len(prompts), "prefix_len": lm._batch_prefix_len,
           "new_tokens": new, "steps": lm.last_batch_steps + 1, "forwards": forwards,
           "seconds": t1 - t0, "prefill_s": marks["prefill_end"] - t0,
           "decode_s": t1 - marks["prefill_end"], "tok_per_s": new / (t1 - t0),
           "decode_tok_per_s": new / (t1 - marks["prefill_end"]),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "flash_launches": flash_n, "int4_launches": int4_n}
    print(json.dumps(row))
    return {**row, "texts": texts}


# Faults planted in the batch prefill, each a keyword that the family's
# forward is not given: per-row RoPE positions (each row then rotates by
# cache slot, off by its left padding) and the pad mask (rows attend their
# padding). Every bound on the batch rows must reject both.
BATCH_FAULTS = {"rope_at_slot_indices": "positions", "pad_mask_ignored": "pad_mask"}
# Batch rows against the single-stream prefill of each prompt: in bf16 on
# the path (flash in the single stream, bf16 rounded in other places), and
# in f32 with the plain kernels, where the two agree but for the order of
# sums. Each bound lies between the sound and the faulty readings on the
# H100 (PERF.md): bf16 sound >= 0.99935, f32 sound 0.9999999, every fault
# <= 0.915.
BATCH_COS_MIN = {"bf16": 0.998, "f32": 0.99999}
# int8-KV batch rows against the bf16-KV batch rows of the same prompts
# (sound 0.9988, faults <= 0.915)
KV8_COS_MIN = 0.995


@contextlib.contextmanager
def as_f32(lm):
    """Within the block lm runs f32 copies of its params with an f32 cache
    and both kernels' plain versions."""
    import torch
    saved = lm.params, lm._cache_dtype
    lm.params, lm._cache_dtype = f32_params(lm.params), torch.float32
    try:
        with plain_kernels():
            yield
    finally:
        lm.params, lm._cache_dtype = saved
        torch.cuda.empty_cache()


def _batch_ids(lm, prompts: list) -> list:
    return [lm._bound_prompt(lm.encode_prompt(p)) for p in prompts]


def batch_prefill_logits(lm, prompts: list, drop: str | None = None):
    """Each row's logits (f32 [B, V], on the CPU) from the batch prefill of
    `prompts` (left-padded, plain attention with the pad mask, the shared
    prefix broadcast), as generate_batch runs it. `drop` names a keyword
    that the family's forward is not given (a planted fault)."""
    import types
    from kjarni_tpu_torch.core.bucketing import seq_bucket
    ids_list = _batch_ids(lm, prompts)
    P = lm._shared_batch_prefix(ids_list)
    bucket = seq_bucket(max(len(r) - P for r in ids_list), lm.max_context - P)
    family = lm.family
    if drop is not None:
        def forward(*args, **kw):
            kw.pop(drop, None)
            return family.forward(*args, **kw)
        lm.family = types.SimpleNamespace(forward=forward, init_cache=family.init_cache)
    try:
        return lm._batch_prefill(ids_list, P, bucket, P + bucket)[0].float().cpu()
    finally:
        lm.family = family


def single_prefill_logits(lm, prompts: list):
    """Each prompt's logits (f32 [B, V], on the CPU) from its single-stream
    prefill (flash at buckets >= 512 where lm takes it)."""
    import torch
    return torch.cat([prefill_logits(lm, ids).cpu() for ids in _batch_ids(lm, prompts)])


def hold_batch_rows(lm, prompts: list, ref, bound: float, what: str):
    """Hold each row of the batch prefill against ref [B, V] at cosine >=
    bound, and check that every planted fault (BATCH_FAULTS) reads below
    it. Prints one line; returns the sound rows' logits. Launches made here
    are not the main path's."""
    import torch
    counts = _counts()

    def min_cos(logits):
        return torch.nn.functional.cosine_similarity(logits, ref, dim=-1).min().item()
    got = batch_prefill_logits(lm, prompts)
    faults = {name: min_cos(batch_prefill_logits(lm, prompts, kw))
              for name, kw in BATCH_FAULTS.items()}
    _restore(counts)
    torch.cuda.empty_cache()
    sound = min_cos(got)
    print(json.dumps({"case": what, "min_cosine": sound,
                      "max_abs_err": (got - ref).abs().max().item(),
                      "bound": f"cosine >= {bound}",
                      **{f"min_cosine_{n}": c for n, c in faults.items()}}))
    check(sound >= bound, f"{what}: cosine {sound} >= {bound}")
    for name, c in faults.items():
        check(c < bound, f"{what}: the planted fault {name} reads {c} < {bound}")
    return got


def batch_rows_vs_single(lm, prompts: list, tag: str, precisions=("bf16", "f32")):
    """hold_batch_rows against the single-stream prefill of each prompt, in
    each of `precisions` (BATCH_COS_MIN). Returns the bf16 rows' logits."""
    out = None
    for prec in precisions:
        with as_f32(lm) if prec == "f32" else contextlib.nullcontext():
            counts = _counts()
            ref = single_prefill_logits(lm, prompts)
            _restore(counts)
            got = hold_batch_rows(lm, prompts, ref, BATCH_COS_MIN[prec],
                                  f"{tag}: batch prefill rows vs single-stream "
                                  f"prefill, {prec}")
        out = got if prec == "bf16" else out
    return out


def phase_batch(d: Path, ran: dict) -> None:
    """B = 8 ragged prompts (300-700 tokens, a 64-token shared prefix) in
    bf16 and int4; B = 8 prompts of ~1,800 tokens with the bf16 and the int8
    KV cache; seeded sampled decoding, single-stream and batched."""
    import torch
    from kjarni_tpu_torch import Generator
    from kjarni_tpu_torch.generate.sampling import GenerationConfig
    greedy = GenerationConfig.greedy(max_new_tokens=64, max_length=4096)
    short = _batch_prompts([300 + 57 * r for r in range(7)] + [700], seed=50)
    long = _batch_prompts([1764 + 10 * r for r in range(8)], seed=60)
    rows = {}
    for quantize in (None, "int4"):
        tag = f"batch {quantize or 'bf16'} B8 300-700"
        gen = Generator(str(d), quantize=quantize)
        rows[tag] = run_batch(gen, short, greedy, tag)
        check(gen.lm._batch_prefix_len == BATCH_PREFIX,
              f"{tag}: shared prefix {gen.lm._batch_prefix_len} == {BATCH_PREFIX}")
        batch_rows_vs_single(gen.lm, short, tag)
        single = ran.get(quantize or "bf16", {}).get("stream_decode_tok_per_s")
        print(json.dumps({"case": f"{tag}: aggregate beside single-stream",
                          "batch_decode_tok_per_s": rows[tag]["decode_tok_per_s"],
                          "single_stream_decode_tok_per_s": single,
                          "peak_mem_gb": rows[tag]["peak_mem_gb"]}))
        if quantize is None:
            tag = "batch bf16 B8 ~1800, bf16 KV"
            rows["long bf16"] = run_batch(gen, long, greedy, tag)
            long_rows = batch_rows_vs_single(gen.lm, long, tag, ("bf16",))
            sampled(gen, short)
        del gen
        torch.cuda.empty_cache()
    gen = Generator(str(d), kv_cache="int8")
    tag = "batch bf16 B8 ~1800, int8 KV"
    rows["long int8"] = run_batch(gen, long, greedy, tag)
    hold_batch_rows(gen.lm, long, long_rows, KV8_COS_MIN,
                    f"{tag}: batch prefill rows vs the bf16-KV batch rows")
    del gen
    torch.cuda.empty_cache()
    print(json.dumps({"case": "batch B8 ~1800 tokens: int8 KV beside bf16 KV",
                      **{f"{k}_{m}": rows[f"long {k}"][m] for k in ("bf16", "int8")
                         for m in ("decode_tok_per_s", "peak_mem_gb", "prefill_s")}}))


def sampled(gen, prompts: list) -> None:
    """Seeded sampled decoding on the card: each seed repeats its stream,
    single-stream and batched, and every draw lies in its filter set."""
    from kjarni_tpu_torch.generate.sampling import GenerationConfig, SamplingParams
    cfg = GenerationConfig(max_new_tokens=64, max_length=4096, strategy="sample",
                           sampling=SamplingParams(**SAMPLING), seed=3)
    one = []
    with DrawCheck() as dc:
        for _ in range(2):
            gen.lm._session_ids = []    # the same prefill both times, no reuse
            one.append(gen.generate(prompts[0], config=cfg))
        single_draws = dc.draws
        many = [gen.generate_batch(prompts, config=cfg) for _ in range(2)]
    check(one[0] == one[1] and one[0], "sampled single stream: the seed repeats it")
    check(many[0] == many[1], "sampled batch: the seed repeats it")
    print(json.dumps({"case": "sampled decoding on the card", "sampling": SAMPLING,
                      "seed": cfg.seed, "single_draws": single_draws,
                      "batch_draws": dc.draws - single_draws,
                      "all_draws_in_filter_sets": True}))


# ---------------------------------------------------------------------------
# phase 7: Chat
# ---------------------------------------------------------------------------

# Llama 3's special tokens at their ids in its 128,256-token vocabulary
LLAMA3_SPECIALS = {"<|begin_of_text|>": 128000, "<|end_of_text|>": 128001,
                   "<|start_header_id|>": 128006, "<|end_header_id|>": 128007,
                   "<|eot_id|>": 128009}


def phase_chat(src: Path, d: Path) -> None:
    """Chat over the phase-3 weights with a tokenizer holding the llama3
    template's specials and <|eot_id|> among the stop ids: three turns of
    ~700, +~600 and ~700 tokens in a 2,048-token context, so the third drops
    the oldest turn."""
    import torch
    from kjarni_tpu_torch import Chat
    d.mkdir()
    for name in ("model.safetensors", "config.json"):
        (d / name).symlink_to(src / name)
    write_tokenizer(d / "tokenizer.json", LLAMA_1B["vocab_size"], LLAMA3_SPECIALS)
    (d / "generation_config.json").write_text(json.dumps(
        {"eos_token_id": [128001, 128008, 128009]}))
    chat = Chat(str(d), system_prompt=_prompt(24, 70), max_context=2048)
    lm = chat.lm
    check(lm.device.type == "cuda" and 128009 in lm.stop_token_ids, "chat on the card")
    msgs = [_prompt(680, 71), _prompt(600, 72), _prompt(700, 73)]
    prev_prompt = 0
    torch.cuda.reset_peak_memory_stats()
    for turn, msg in enumerate(msgs, 1):
        before = list(lm._session_ids)
        f0, i0 = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n, t_first = 0, None
        for _ in chat.stream(msg, preset="greedy", max_new_tokens=64, max_length=4096):
            if n == 0:
                torch.cuda.synchronize()
                t_first = time.perf_counter()
            n += 1
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        flash_n, int4_n = (a - b for a, b in zip(_counts(), (f0, i0)))
        prompt = lm._session_ids[:len(lm._session_ids) - n]
        common = _common_prefix(before, prompt)
        reused = common if common >= lm._min_reuse_prefix else 0
        check(n > 0, f"chat turn {turn}: a reply")
        check(flash_n == lm.config.num_layers and int4_n == 0,
              f"chat turn {turn}: {flash_n} flash launches, expected {lm.config.num_layers}")
        check(lm.last_prefill_tokens == len(prompt) - reused,
              f"chat turn {turn}: prefilled {lm.last_prefill_tokens} of {len(prompt)} "
              f"with {reused} cached")
        if turn == 2:
            check(reused >= prev_prompt, f"chat turn 2 reuses turn 1's prompt ({reused})")
        if turn == 3:
            check(all(m.content != msgs[0] for m in chat.conversation.messages),
                  "chat turn 3 dropped the oldest turn")
        prev_prompt = len(prompt)
        print(json.dumps({"chat_turn": turn, "prompt_tokens": len(prompt),
                          "reused_tokens": reused, "prefilled_tokens": lm.last_prefill_tokens,
                          "new_tokens": n, "ttft_ms": 1e3 * (t_first - t0),
                          "decode_tok_per_s": (n - 1) / (t_end - t_first) if n > 1 else None,
                          "messages": len(chat.conversation.messages),
                          "flash_launches": flash_n}))
    print(json.dumps({"case": "chat", "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    del chat, lm
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: GPT-2
# ---------------------------------------------------------------------------

# GPT-2's public config.json values (openai-community/gpt2)
GPT2 = {"model_type": "gpt2", "architectures": ["GPT2LMHeadModel"], "vocab_size": 50257,
        "n_embd": 768, "n_layer": 12, "n_head": 12, "n_positions": 1024, "n_ctx": 1024,
        "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5,
        "bos_token_id": 50256, "eos_token_id": 50256}


def write_gpt2_dir(d: Path, seed: int = 0) -> None:
    """config.json, tokenizer.json and model.safetensors of random f32
    weights (N(0, 0.02), biases too; norms ones) in GPT-2's checkpoint
    layout (Conv1D weights [in, out])."""
    import torch
    from kjarni_tpu_torch.weights.safetensors_loader import save_file
    c = GPT2
    H, V = c["n_embd"], c["vocab_size"]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return (torch.randn(*shape, generator=g, device="cuda") * 0.02).cpu()

    t = {"transformer.wte.weight": rnd(V, H), "transformer.wpe.weight": rnd(c["n_positions"], H),
         "transformer.ln_f.weight": torch.ones(H), "transformer.ln_f.bias": rnd(H)}
    for i in range(c["n_layer"]):
        p = f"transformer.h.{i}."
        t.update({p + "ln_1.weight": torch.ones(H), p + "ln_1.bias": rnd(H),
                  p + "ln_2.weight": torch.ones(H), p + "ln_2.bias": rnd(H),
                  p + "attn.c_attn.weight": rnd(H, 3 * H), p + "attn.c_attn.bias": rnd(3 * H),
                  p + "attn.c_proj.weight": rnd(H, H), p + "attn.c_proj.bias": rnd(H),
                  p + "mlp.c_fc.weight": rnd(H, 4 * H), p + "mlp.c_fc.bias": rnd(4 * H),
                  p + "mlp.c_proj.weight": rnd(4 * H, H), p + "mlp.c_proj.bias": rnd(H)})
    d.mkdir(parents=True, exist_ok=True)
    save_file(t, d / "model.safetensors")
    (d / "config.json").write_text(json.dumps(c))
    write_tokenizer(d / "tokenizer.json", V)


def phase_gpt2(d: Path) -> None:
    """GPT-2 at its public widths: a greedy generate on a 700-token prompt
    and a B = 8 generate_batch on the card, neither launching a kernel; the
    card's bf16 logits against the f32 forward on the CPU."""
    import torch
    from kjarni_tpu_torch import Generator
    from kjarni_tpu_torch.generate.sampling import GenerationConfig
    from kjarni_tpu_torch.models.decoder_lm import DecoderLM
    t0 = time.perf_counter()
    write_gpt2_dir(d, seed=80)
    print(f"gpt2 dir written: {time.perf_counter() - t0:.1f} s")
    gen = Generator(str(d))
    lm = gen.lm
    check(lm.device.type == "cuda" and lm.config.arch == "gpt2" and not lm._flash_ok,
          "gpt2 on the card, no flash")
    greedy = GenerationConfig.greedy(max_new_tokens=64, max_length=1024)
    text = _prompt(700, 81, hi=50000)
    c0 = _counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    first = {}
    for st in gen.generate_stream(text, config=greedy):
        if "t" not in first:
            torch.cuda.synchronize()
            first["t"] = time.perf_counter()
        first["n"] = first.get("n", 0) + 1
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    check(first.get("n", 0) > 0, "gpt2 generate: tokens")
    ids = lm.encode_prompt(text)
    gen_row = {"gpt2": "generate 700", "prompt_tokens": len(ids), "new_tokens": first["n"],
               "ttft_ms": 1e3 * (first["t"] - t),
               "decode_tok_per_s": (first["n"] - 1) / (t_end - first["t"]),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps(gen_row))
    prompts = _batch_prompts([200 + 36 * r for r in range(8)], seed=82, hi=50000,
                             prefix_words=BATCH_PREFIX)
    run_batch(gen, prompts, greedy, "gpt2 batch B8 200-452")
    check(lm._batch_prefix_len == BATCH_PREFIX, f"gpt2 batch prefix {lm._batch_prefix_len}")
    check(_counts() == c0, f"gpt2 launched no kernel ({c0} -> {_counts()})")
    # the card's bf16 logits against the same weights' f32 forward on the CPU
    got = prefill_logits(lm, ids)[0].cpu()
    cpu = DecoderLM(d, device="cpu")
    want = prefill_logits(cpu, ids, device="cpu")[0]
    cos = _cosine(got, want)
    err = (got - want).abs().max().item()
    check(bool(torch.isfinite(got).all()) and got.shape == (GPT2["vocab_size"],),
          "gpt2 logits finite, of the vocab's shape")
    check(cos >= 0.999, f"gpt2 bf16 card vs f32 CPU logits: cosine {cos} >= 0.999")
    print(json.dumps({"case": "gpt2 bf16 card vs f32 CPU, first prefill logits",
                      "cosine": cos, "max_abs_err": err,
                      "max_abs_ref": want.abs().max().item(), "bound": "cosine >= 0.999"}))
    del gen, lm, cpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: serving (continuous engine, speculative decoding, HTTP) and GGUF
# ---------------------------------------------------------------------------

SERVE_SLOTS, SERVE_SYSTEM = 8, 256      # slots; system prompt tokens (BOS + 255 words)
SERVE_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9, min_p=0.0)
# The teacher-forced check: every greedy token the engine (or the
# speculative loop) emits must lie within SERVE_TIE_BAND logits of the
# maximum of its position's row in one plain single-stream prefill of the
# prompt and output. Random weights give flat logits, so bf16 flips near-ties:
# on the H100 the sound runs read at most 0.125 (int4) and 0.078 (bf16), each
# planted fault (SERVE_FAULTS) at least 1.54 (PERF.md, §6). Also printed, and
# held in f32 (f32 copies of params and cache, plain kernels) at
# BATCH_COS_MIN["f32"] as the batch phase holds its rows: the cosine of each
# greedy request's admission row and first SERVE_CHECK_STEPS decode rows
# against the same forward.
SERVE_TIE_BAND = 0.5
SERVE_LAYERS = 4            # the served model's depth here: full width, cut depth
SERVE_CHECK_STEPS = 4
SERVE_FAULTS = ("decode_at_pos_minus_1", "admission_scatter_permuted",
                "flash_wave_q_offset_0")


def _serve_mix(seed: int) -> list:
    """Three bursts of 8 requests: (suffix tokens, new tokens, sampled). The
    first burst's suffixes (1,100-1,800 tokens) admit as one 8-lane wave at
    bucket 2048 (the flash plan: 4 * 32 * 2048 * 2304 * 8 = 4.8 GB of scores
    over the 2 GB gate); the later bursts' (100-1,000) take plain plans. One
    request in three samples."""
    import random
    g = random.Random(seed)
    return [[(g.randint(*((1100, 1800) if b == 0 else (100, 1000))), g.randint(32, 128),
              i % 3 == 2) for i in range(8)] for b in range(3)]


def _teacher_forced(lm, ids: list, rows: list):
    """Logits (f32, CPU) at positions `rows` of one plain prefill forward of
    `ids` over a fresh cache (no flash; the kernels' plain versions): the
    single-stream reference a request's logits are held against. Its
    launches are not the main path's."""
    import torch
    counts = _counts()
    with plain_kernels(), torch.inference_mode():
        ck, cv = lm._new_cache(1, len(ids))
        x = lm.family.forward_hidden(lm.params, lm.config,
                                     torch.tensor([ids], device=lm.device), ck, cv, 0)
        out = lm.family.head_logits(lm.params, lm.config, x[0, rows]).float().cpu()
    del ck, cv, x
    _restore(counts)
    return out


def _margins(ref, toks: list) -> list:
    """max(row) - row[token] of each reference row and the token emitted
    there: 0 where the emitted token is the reference's argmax."""
    return [float(r.max() - r[t]) for r, t in zip(ref, toks)]


class EngineProbe:
    """Instruments one ContinuousEngine: waves per plan mode, decode steps,
    each request's first-token time, and optionally the engine's logits
    (each request's admission row and its first SERVE_CHECK_STEPS decode
    rows), with a planted fault (SERVE_FAULTS): decode_at_pos_minus_1 on
    one active slot per window, in turn over the active slots."""

    def __init__(self, eng, prompt_len: dict, capture: bool = False, fault=None):
        import types
        from kjarni_tpu_torch.models import llama as kllama
        self.modes, self.steps, self.first = {}, 0, {}
        self.adm, self.dec = {}, {}
        fam, wave, window, note = eng.family, eng._admit_wave, eng._window, eng._note_token
        state = {"wave": [], "win": [], "step": 0}

        def admit_wave(grp, pi, m, bucket):
            mode = eng._admit_plan(bucket, m)["mode"]
            self.modes[mode] = self.modes.get(mode, 0) + 1
            state["wave"] = [req[0] for _, req in grp]
            if fault == "flash_wave_q_offset_0":
                attend = kllama.flash_attention

                def at_zero(q, k, v, **kw):   # queries as if no prefix preceded them
                    return attend(q, k, v, **{**kw, "q_offset": 0})
                kllama.flash_attention = at_zero
                try:
                    wave(grp, pi, m, bucket)
                finally:
                    kllama.flash_attention = attend
            else:
                wave(grp, pi, m, bucket)
            if fault == "admission_scatter_permuted" and len(grp) > 1:
                # each lane's cache lands in the next lane's slot
                slots = [s for s, _ in grp]
                for c in (eng.cache_k, eng.cache_v):
                    c[:, slots] = c[:, slots[1:] + slots[:1]]

        def win(k, plain, kb, pos):
            self.steps += k
            state["win"] = [(i, s.request_id, pos[i]) for i, s in enumerate(eng._slots)
                            if s.active]
            state["step"] = 0
            state["windows"] = state.get("windows", -1) + 1
            return window(k, plain, kb, pos)

        def forward(params, cfg, ids, ck, cv, pos_start, *a, **kw):
            if fault == "decode_at_pos_minus_1" and state["win"]:
                i = state["win"][state["windows"] % len(state["win"])][0]
                pos_start = pos_start.clone()
                pos_start[i] -= 1
            out = fam.forward(params, cfg, ids, ck, cv, pos_start, *a, **kw)
            for i, rid, p0 in state["win"]:
                j = p0 + state["step"] - prompt_len[rid]
                if j < SERVE_CHECK_STEPS:
                    self.dec[(rid, j)] = out[0][i].float().cpu()
            state["step"] += 1
            return out

        def head_logits(params, cfg, x):
            out = fam.head_logits(params, cfg, x)
            for j, rid in enumerate(state["wave"]):
                self.adm[rid] = out[j].float().cpu()
            return out

        def note_token(slot_idx, tok):
            self.first.setdefault(eng._slots[slot_idx].request_id, time.perf_counter())
            note(slot_idx, tok)

        eng._admit_wave, eng._window, eng._note_token = admit_wave, win, note_token
        if capture:
            eng.family = types.SimpleNamespace(
                forward=forward, forward_hidden=fam.forward_hidden,
                head_logits=head_logits, init_cache=fam.init_cache)


class SlotDrawCheck:
    """Within the block, every draw of the continuous engine's sampled
    slots is checked to lie in its slot's top-k / top-p / min-p set
    (_keep_mask over the same penalised logits)."""

    def __init__(self):
        self.draws = 0

    def __enter__(self):
        from kjarni_tpu_torch.generate import continuous
        from kjarni_tpu_torch.generate.sampling import SamplingParams
        self._orig = orig = continuous._sample_slot

        def checked(logits, generators, rows, temp, top_k, top_p, min_p):
            tok = orig(logits, generators, rows, temp, top_k, top_p, min_p)
            if rows:
                lg = logits[rows].float().cpu().numpy()
                for j, r in enumerate(rows):
                    sp = SamplingParams(temperature=float(temp[r]), top_k=int(top_k[r]),
                                        top_p=float(top_p[r]), min_p=float(min_p[r]))
                    check(bool(_keep_mask(lg[j], sp)[int(tok[r])]),
                          f"slot {r}: sampled token lies in its top-k/top-p/min-p set")
                self.draws += len(rows)
            return tok
        continuous._sample_slot = checked
        return self

    def __exit__(self, *exc):
        from kjarni_tpu_torch.generate import continuous
        continuous._sample_slot = self._orig


@contextlib.contextmanager
def int4_shapes(hist: dict):
    """Within the block, count the int4 launches of the model's projections
    by M (the rows of x)."""
    from kjarni_tpu_torch.models import llama as kllama
    orig = kllama.int4_matvec

    def counted(x, w4, scale):
        hist[x.shape[0]] = hist.get(x.shape[0], 0) + 1
        return orig(x, w4, scale)
    kllama.int4_matvec = counted
    try:
        yield hist
    finally:
        kllama.int4_matvec = orig


def run_engine(lm, system: str, bursts: list, seed: int, capture=False, fault=None,
               profile=False, score_limit=None) -> dict:
    """One ContinuousEngine run (slots 8, 4,096 slots each, windows of up to
    8 steps): the system prompt registered, burst 1 submitted at once,
    burst 2 after 4 windows and burst 3 after 4 more (they join mid-flight),
    then every request to its end. score_limit, where given, replaces the
    admission gate's 2 GB (1 sends every wave to the flash plan). Returns ids
    per request and the numbers."""
    import torch
    from kjarni_tpu_torch.generate.continuous import ContinuousEngine
    from kjarni_tpu_torch.generate.sampling import SamplingParams
    eng = ContinuousEngine(lm, slots=SERVE_SLOTS, max_context=4096, steps_per_sync=8)
    if score_limit is not None:
        eng._admit_score_limit = score_limit
    sys_n = eng.register_prefix(system)
    check(sys_n == SERVE_SYSTEM, f"system prompt of {sys_n} tokens")
    prompt_len, meta, submitted = {}, {}, {}
    probe = EngineProbe(eng, prompt_len, capture, fault)
    prof = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b, burst in enumerate(bursts):
        if b:
            for _ in range(4):
                eng.step()
            if profile and b == 1:
                prof = profile_call(eng.step)
        for i, (sfx, new, sampled) in enumerate(burst):
            ids = lm.encode_prompt(system) + lm.encode_prompt(
                _prompt(sfx, seed + 8 * b + i), add_bos=False)
            sp = SamplingParams(**SERVE_SAMPLING) if sampled else None
            rid = eng.submit(token_ids=ids, max_new_tokens=new, sampling=sp,
                             seed=seed + 8 * b + i if sampled else None, defer_admit=True)
            prompt_len[rid], meta[rid] = len(ids), (ids, sampled)
            submitted[rid] = time.perf_counter()
    done = {fr.request_id: fr for fr in eng.run()}
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ttft = sorted(1e3 * (probe.first[r] - submitted[r]) for r in done)
    new = sum(len(fr.token_ids) for fr in done.values())
    return {"eng": eng, "probe": probe, "done": done, "meta": meta, "seconds": secs,
            "new_tokens": new, "tok_per_s": new / secs, "profile": prof,
            "ttft_ms_p50": statistics.median(ttft),
            "ttft_ms_p95": ttft[min(len(ttft) - 1, int(0.95 * len(ttft)))]}


def hold_engine_rows(lm, run: dict) -> dict:
    """Each greedy request's captured engine rows against the teacher-forced
    reference: the cosine of its admission row and first decode rows, and
    the margin of every emitted token (max(ref) - ref[token])."""
    import torch
    cos, margins = [], []
    for rid, (ids, sampled) in run["meta"].items():
        out = run["done"][rid].token_ids
        if sampled or not out:
            continue
        P = len(ids)
        ref = _teacher_forced(lm, ids + out, list(range(P - 1, P + len(out) - 1)))
        margins += _margins(ref, out)
        rows = [(run["probe"].adm.get(rid), ref[0])]
        rows += [(run["probe"].dec.get((rid, j)), ref[j + 1])
                 for j in range(min(SERVE_CHECK_STEPS, len(out) - 1))]
        cos += [torch.nn.functional.cosine_similarity(a, b, dim=0).item()
                for a, b in rows if a is not None]
    ms = sorted(margins)
    return {"min_cosine": min(cos), "rows": len(cos), "tokens": len(ms),
            "max_margin": ms[-1], "p99_margin": ms[int(0.99 * (len(ms) - 1))],
            "tokens_off_argmax": sum(m > 0 for m in ms)}


def serve_engine(d: Path, quantize) -> dict:
    """The continuous engine over the phase-3 weights: run A timed, run B
    (the same schedule) checked, then the planted faults on a smaller mix."""
    import torch
    from kjarni_tpu_torch import Generator
    tag = quantize or "bf16"
    lm = Generator(str(d), quantize=quantize).lm
    system = _prompt(SERVE_SYSTEM - 1, 100)
    bursts = _serve_mix(seed=7)
    c0 = _counts()
    gc.collect()     # earlier probes' closures hold their engines in cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with int4_shapes({}) as shapes:
        a = run_engine(lm, system, bursts, seed=300)
    flash_n, int4_n = (x - y for x, y in zip(_counts(), c0))
    eng = a["eng"]
    check(a["probe"].modes.get("flash", 0) >= 1 and a["probe"].modes.get("plain", 0) >= 1,
          f"{tag} engine: flash and plain admission waves ({a['probe'].modes})")
    layers = lm.config.num_layers
    check(flash_n == layers * a["probe"].modes.get("flash", 0),
          f"{tag} engine: {flash_n} flash launches, {layers} per flash wave")
    forwards = 1 + eng.stats["admission_waves"] + a["probe"].steps
    want4 = int4_per_forward(layers) * forwards if quantize == "int4" else 0
    check(int4_n == want4, f"{tag} engine: {int4_n} int4 launches, expected {want4}")
    if quantize == "int4":
        check(shapes.get(SERVE_SLOTS, 0) > 0 and shapes.get(8 * 2048, 0) > 0,
              f"{tag} engine: int4 at M = 8 (decode) and 16,384 (8 x 2048 wave): {shapes}")
    row = {"serve": f"engine {tag}", "requests": len(a["done"]),
           "windows": eng.stats["windows"], "decode_steps": a["probe"].steps,
           "admission_waves": eng.stats["admission_waves"],
           "prefix_hits": eng.stats["prefix_hits"], "waves_by_plan": a["probe"].modes,
           "plans": {f"{b}+{m}": p["mode"] for (b, m), p in eng._admit_plans.items()},
           "flash_launches": flash_n, "int4_launches": int4_n, "int4_launches_by_M": shapes,
           "new_tokens": a["new_tokens"], "seconds": a["seconds"],
           "tok_per_s": a["tok_per_s"], "ttft_ms_p50": a["ttft_ms_p50"],
           "ttft_ms_p95": a["ttft_ms_p95"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del a["eng"], eng
    # run B: the same schedule, with the draws checked and the logits held
    counts = _counts()
    with SlotDrawCheck() as dc:
        b = run_engine(lm, system, bursts, seed=300, capture=True, profile=True)
    _restore(counts)
    for rid, fr in a["done"].items():
        kind = "sampled" if a["meta"][rid][1] else "greedy"
        check(b["done"][rid].token_ids == fr.token_ids,
              f"{tag} engine: request {rid} ({kind}) repeats its stream in a second run")
    held = hold_engine_rows(lm, b)
    row.update({f"sound_{k}": v for k, v in held.items()})
    row.update({"sampled_draws_checked": dc.draws, **(b["profile"] or {})})
    del b
    check(held["max_margin"] <= SERVE_TIE_BAND,
          f"{tag} engine: greedy tokens within {SERVE_TIE_BAND} of the teacher-forced "
          f"maximum ({held['max_margin']})")
    # the planted faults, on a mix of 8 greedy requests in two bursts whose
    # waves all take the flash plan (the gate shrunk to 1 byte), in bf16
    # (the margin) and in f32 (the cosine, with flash's plain version); each
    # must fail both
    small = [[(200 + 100 * i, 8, False) for i in range(4)],
             [(150 + 120 * i, 8, False) for i in range(4)]]
    counts = _counts()
    for prec in ("bf16", "f32"):
        with as_f32(lm) if prec == "f32" else contextlib.nullcontext():
            for fault in (None, *SERVE_FAULTS):
                run = run_engine(lm, system, small, seed=500, capture=True, fault=fault,
                                 score_limit=1)
                check(set(run["probe"].modes) == {"flash"},
                      f"{tag} engine, {prec}, {fault or 'sound'}: every wave takes the "
                      f"flash plan ({run['probe'].modes})")
                got = hold_engine_rows(lm, run)
                del run
                row.update({f"{prec}_{fault or 'sound'}_{k}": v for k, v in got.items()})
                ok = (got["max_margin"] <= SERVE_TIE_BAND if prec == "bf16"
                      else got["min_cosine"] >= BATCH_COS_MIN["f32"])
                check(ok == (fault is None),
                      f"{tag} engine, {prec}, {fault or 'sound'}: margin {got['max_margin']}"
                      f" (band {SERVE_TIE_BAND}), cosine {got['min_cosine']} (f32 bound "
                      f"{BATCH_COS_MIN['f32']}): {'passes' if fault is None else 'fails'}")
    _restore(counts)
    print(json.dumps(row))
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    return row


def serve_speculative(d: Path, tmp: Path, quantize) -> list:
    """SpeculativeGenerator over the weights of d as the target, with two
    drafts: the target's first 2 layers (same embedding and head) and the
    target itself. Each output is held by the teacher-forced check (every
    emitted token's margin); the cosine of the target pass's rows of the
    emitted tokens against the same forward is printed, and the target's own
    greedy stream of the same tokens times the single stream beside it."""
    import types
    import torch
    from kjarni_tpu_torch import Generator
    from kjarni_tpu_torch.generate.sampling import GenerationConfig
    from kjarni_tpu_torch.generate.speculative import SpeculativeGenerator
    from kjarni_tpu_torch.models.decoder_lm import DecoderLM
    tag = quantize or "bf16"
    dd = tmp / f"llama-3.2-1b-first-2-layers-{tag}"
    if not dd.exists():
        dd.mkdir()
        for name in ("model.safetensors", "tokenizer.json"):
            (dd / name).symlink_to(d / name)
        (dd / "config.json").write_text(json.dumps({**LLAMA_1B, "num_hidden_layers": 2}))
    target = Generator(str(d), quantize=quantize).lm
    drafts = {"2-layer draft": DecoderLM(dd, quantize=quantize), "self-draft": target}
    ids = target.encode_prompt(_prompt(600, 90))
    cfg = GenerationConfig.greedy(max_new_tokens=128, max_length=4096)
    counts = _counts()     # the yardstick's launches are not the path's
    steps = []
    for st in target.generate_stream(token_ids=ids, config=cfg):
        steps.append(time.perf_counter())
    _restore(counts)
    single_tps = (len(steps) - 1) / (steps[-1] - steps[0])
    rows = []
    for name, draft in drafts.items():
        spec = SpeculativeGenerator(target, draft, num_tokens=4)
        c0 = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with int4_shapes({}) as shapes:
            out = [st.id for st in spec.generate_stream(token_ids=ids, config=cfg)]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        flash_n, int4_n = (x - y for x, y in zip(_counts(), c0))
        want = target.config.num_layers + draft.config.num_layers
        check(len(out) > 0 and flash_n == want,
              f"spec {tag} {name}: {flash_n} flash launches, expected {want} (the "
              f"target's and the draft's prefills at bucket 1024)")
        if quantize == "int4":
            check(shapes.get(spec.k + 1, 0) > 0 and shapes.get(1, 0) > 0,
                  f"spec {tag} {name}: int4 at M = 5 (target pass) and 1 (draft): {shapes}")
        row = {"serve": f"speculative {tag} {name}", "new_tokens": len(out),
               "seconds": secs, "tok_per_s": len(out) / secs,
               "single_stream_decode_tok_per_s": single_tps,
               "rounds": spec.last_rounds, "acceptance_rate": spec.last_acceptance_rate,
               "flash_launches": flash_n, "int4_launches": int4_n,
               "int4_launches_by_M": shapes}
        # a second run records the target passes: (slot, inputs, logits)
        fam, passes = target.family, []

        def record(params, cfg_, toks, ck, cv, pos):
            out_ = fam.forward_all_logits(params, cfg_, toks, ck, cv, pos)
            if toks.shape[1] == spec.k + 1:
                passes.append((pos, toks[0].tolist(), out_[0][0].float().cpu()))
            return out_
        target.family = types.SimpleNamespace(
            forward=fam.forward, forward_hidden=fam.forward_hidden,
            head_logits=fam.head_logits, init_cache=fam.init_cache,
            forward_all_logits=record)
        counts = _counts()
        try:
            again = [st.id for st in spec.generate_stream(token_ids=ids, config=cfg)]
        finally:
            target.family = fam
        _restore(counts)
        check(again == out, f"spec {tag} {name}: a second run repeats the output")
        # the rows whose inputs are the emitted sequence, against the reference
        P, seq = len(ids), ids + out
        ref = _teacher_forced(target, seq, list(range(P - 1, P + len(out) - 1)))
        cos = []
        for pos, toks, lg in passes:
            for i, t in enumerate(toks):
                j = pos + i - (P - 1)
                if j >= len(out) or seq[pos + i] != t:
                    break
                cos.append(torch.nn.functional.cosine_similarity(lg[i], ref[j], dim=0).item())
        ms = sorted(_margins(ref, out))
        row.update({"min_cosine": min(cos), "rows": len(cos), "max_margin": ms[-1],
                    "tokens_off_argmax": sum(m > 0 for m in ms)})
        print(json.dumps(row))
        check(ms[-1] <= SERVE_TIE_BAND, f"spec {tag} {name}: tokens within "
                                        f"{SERVE_TIE_BAND} of the teacher-forced maximum "
                                        f"({ms[-1]})")
        rows.append(row)
    del target, drafts
    torch.cuda.empty_cache()
    return rows


def serve_http(d: Path) -> dict:
    """serve.py's server on 127.0.0.1:0 in a thread (--scheduler continuous,
    the phase-3 model dir): /health, 8 concurrent /v1/generate,
    /v1/completions, a streamed /v1/chat/completions and /v1/batch_stats;
    each must answer 200, the generate and completion texts with the texts
    the engine finished."""
    import threading
    import urllib.request
    from kjarni_tpu_torch import serve
    engine = serve._Engine({"generate": str(d), "chat": str(d)}, scheduler="continuous",
                           max_batch=SERVE_SLOTS, steps_per_sync=8)
    srv = serve.KjarniHTTPServer(("127.0.0.1", 0), serve.make_handler(engine))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_port}"
    gen = engine.get("generate", None)
    runner = engine._continuous(gen)
    finished, fin = [], runner._engine._finish

    def finish(slot_idx, reason):
        fin(slot_idx, reason)
        finished.append(runner._engine._finished[-1].text)
    runner._engine._finish = finish

    def call(path, body=None, stream=False):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(base + path, data=data,
                                     headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            raw = r.read().decode()
            code = r.status
        ms = 1e3 * (time.perf_counter() - t)
        check(code == 200, f"HTTP {path}: {code}")
        if stream:
            frames = [f[6:] for f in raw.split("\n") if f.startswith("data: ")]
            check(frames and frames[-1] == "[DONE]", f"HTTP {path}: SSE ends with [DONE]")
            return [json.loads(f) for f in frames[:-1]], ms
        return json.loads(raw), ms

    try:
        health, ms_health = call("/health")
        check(health == {"status": "ok"}, "HTTP /health")
        res = {}

        def client(i):
            res[i] = call("/v1/generate", {"prompt": _prompt(150 + 40 * i, 400 + i),
                                           "max_new_tokens": 32, "preset": "greedy"})
        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        burst_s = time.perf_counter() - t0
        texts = [res[i][0]["text"] for i in range(8)]
        check(sorted(texts) == sorted(finished) and len(texts) == 8,
              "HTTP /v1/generate: the 8 texts are the engine's")
        comp, ms_comp = call("/v1/completions", {"prompt": _prompt(300, 410),
                                                 "max_tokens": 16, "temperature": 0})
        check(comp["choices"][0]["text"] == finished[-1],
              "HTTP /v1/completions: the engine's text")
        chunks, ms_chat = call("/v1/chat/completions", {
            "messages": [{"role": "user", "content": _prompt(200, 420)}],
            "max_tokens": 16, "temperature": 0, "stream": True}, stream=True)
        check(len(chunks) > 2 and chunks[-1]["choices"][0]["finish_reason"] in
              ("stop", "length"), "HTTP /v1/chat/completions: SSE chunks")
        stats, ms_stats = call("/v1/batch_stats", {})
        cont = stats["continuous"][gen.model_id]
        check(cont["finished"] == 9 and cont["submitted"] == 9, f"HTTP batch_stats {cont}")
        row = {"serve": "http continuous", "health_ms": ms_health,
               "generate_ms": sorted(res[i][1] for i in range(8)),
               "generate_burst_s": burst_s, "completions_ms": ms_comp,
               "chat_stream_ms": ms_chat, "chat_chunks": len(chunks),
               "batch_stats_ms": ms_stats, "batch_stats": cont}
    finally:
        srv.shutdown()
        srv.server_close()
        runner.shutdown()
    print(json.dumps(row))
    return row


def _gguf_kv(key: str, value) -> bytes:
    """One GGUF metadata pair: u32 ints, f32 floats, strings, and arrays of
    strings or of i32."""
    import struct

    def s(x: str) -> bytes:
        b = x.encode()
        return struct.pack("<Q", len(b)) + b
    if isinstance(value, list):
        if isinstance(value[0], str):
            body = struct.pack("<IQ", 8, len(value)) + b"".join(s(v) for v in value)
        else:
            body = struct.pack(f"<IQ{len(value)}i", 5, len(value), *value)
        return s(key) + struct.pack("<I", 9) + body
    if isinstance(value, float):
        return s(key) + struct.pack("<If", 6, value)
    if isinstance(value, int):
        return s(key) + struct.pack("<II", 4, value)
    return s(key) + struct.pack("<I", 8) + s(value)


def write_gguf_file(path: Path, tensors: dict, metadata: dict) -> None:
    """A GGUF v3 file: tensors {name: (dims ne0-first, ggml type, raw bytes)},
    32-byte aligned."""
    import struct
    head = struct.pack("<IIQQ", 0x46554747, 3, len(tensors), len(metadata))
    head += b"".join(_gguf_kv(k, v) for k, v in metadata.items())
    offset = 0
    for name, (dims, ttype, raw) in tensors.items():
        b = name.encode()
        head += struct.pack(f"<Q{len(b)}sI", len(b), b, len(dims))
        head += struct.pack(f"<{len(dims)}QIQ", *dims, ttype, offset)
        offset += len(raw) + (-len(raw)) % 32
    with open(path, "wb") as f:
        f.write(head + b"\0" * ((-len(head)) % 32))
        for _, _, raw in tensors.values():
            f.write(raw)
            f.write(b"\0" * ((-len(raw)) % 32))


def q8_0(w):
    """Q8_0 blocks of f32 tensor w (rows of a multiple of 32), computed on
    w's device: (raw bytes, the dequantized f32 values on the CPU as a reader
    computes them, f16 scale times int8)."""
    import torch
    blocks = w.reshape(-1, 32)
    d = (blocks.abs().amax(dim=1, keepdim=True) / 127.0).half()
    d[d == 0] = 1.0
    q = torch.round(blocks / d.float()).clamp(-127, 127).to(torch.int8)
    raw = torch.cat([d.view(torch.uint8), q.view(torch.uint8)], dim=1)
    return raw.cpu().numpy().tobytes(), (d.float() * q.float()).reshape(w.shape).cpu()


def gguf_bpe_metadata(vocab: int) -> dict:
    """tokenizer.ggml.* of a byte-level BPE over `vocab` ids: the 256 byte
    symbols, every merge of two of them, then merges of those pairs with a
    third symbol up to id 128,000, then 256 specials (<|begin_of_text|> = 128000, <|end_of_text|> = 128001,
    reserved tokens), as Llama 3 lays them out."""
    from kjarni_tpu_torch.tokenizer_native import bytes_to_unicode
    syms = list(bytes_to_unicode().values())
    n_plain = LLAMA3_SPECIALS["<|begin_of_text|>"]
    pairs = [(a, b) for a in syms for b in syms]                 # 65,536
    merges = list(itertools.islice(itertools.chain(pairs, ((a + b, c) for a, b in pairs
                                                           for c in syms)),
                                   n_plain - len(syms)))
    specials = [f"<|reserved_special_token_{i}|>" for i in range(vocab - n_plain)]
    specials[0], specials[1] = "<|begin_of_text|>", "<|end_of_text|>"
    tokens = syms + [a + b for a, b in merges] + specials
    return {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.merges": [f"{a} {b}" for a, b in merges],
            "tokenizer.ggml.token_type": [1] * n_plain + [3] * (vocab - n_plain),
            "tokenizer.ggml.bos_token_id": n_plain, "tokenizer.ggml.eos_token_id": n_plain + 1}


def serve_gguf(tmp: Path) -> dict:
    """A Llama-3.2-1B-width GGUF at 2 layers (Q8_0 embedding and projections,
    F32 norms, tied head) with the embedded BPE over 128,256 ids, loaded by
    DecoderLM(dir); its params and first-prefill logits against the same
    dequantized weights written as safetensors."""
    import numpy as np
    import torch
    from kjarni_tpu_torch.models.decoder_lm import DecoderLM
    from kjarni_tpu_torch.tokenizer_native import BPETokenizer
    from kjarni_tpu_torch.weights.gguf import GgufWeights
    from kjarni_tpu_torch.weights.safetensors_loader import save_file
    c, L = LLAMA_1B, 2
    H, I_, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    qd, kvd = c["num_attention_heads"] * c["head_dim"], c["num_key_value_heads"] * c["head_dim"]
    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    gw = torch.Generator(device="cuda").manual_seed(11)
    md = {"general.architecture": "llama", "llama.block_count": L,
          "llama.embedding_length": H, "llama.feed_forward_length": I_,
          "llama.attention.head_count": c["num_attention_heads"],
          "llama.attention.head_count_kv": c["num_key_value_heads"],
          "llama.context_length": 8192, "llama.rope.freq_base": c["rope_theta"],
          "llama.attention.layer_norm_rms_epsilon": c["rms_norm_eps"],
          "llama.vocab_size": V, **gguf_bpe_metadata(V)}
    tensors, dense = {}, {}

    def add(gname, hname, out_f, in_f):
        raw, deq = q8_0(torch.randn(out_f, in_f, generator=gw, device="cuda") * 0.02)
        tensors[gname], dense[hname] = ([in_f, out_f], 8, raw), deq

    ones = torch.ones(H)
    add("token_embd.weight", "model.embed_tokens.weight", V, H)
    norm = ([H], 0, ones.numpy().tobytes())
    tensors["output_norm.weight"], dense["model.norm.weight"] = norm, ones
    for i in range(L):
        g, h = f"blk.{i}.", f"model.layers.{i}."
        for gn, hn, o, n in (("attn_q", "self_attn.q_proj", qd, H),
                             ("attn_k", "self_attn.k_proj", kvd, H),
                             ("attn_v", "self_attn.v_proj", kvd, H),
                             ("attn_output", "self_attn.o_proj", H, qd),
                             ("ffn_gate", "mlp.gate_proj", I_, H), ("ffn_up", "mlp.up_proj", I_, H),
                             ("ffn_down", "mlp.down_proj", H, I_)):
            add(g + gn + ".weight", h + hn + ".weight", o, n)
        for gn, hn in (("attn_norm", "input_layernorm"),
                       ("ffn_norm", "post_attention_layernorm")):
            tensors[g + gn + ".weight"], dense[h + hn + ".weight"] = norm, ones
    gd, sd = tmp / "llama-1b-width-2-layers-gguf", tmp / "llama-1b-width-2-layers-st"
    gd.mkdir()
    sd.mkdir()
    write_gguf_file(gd / "model.gguf", tensors, md)
    save_file(dense, sd / "model.safetensors")
    (sd / "config.json").write_text(json.dumps(GgufWeights(gd / "model.gguf").hf_config()))
    write_tokenizer(sd / "tokenizer.json", V)
    del tensors, dense
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lg = DecoderLM(gd)
    torch.cuda.synchronize()
    load_gguf_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ls = DecoderLM(sd)
    torch.cuda.synchronize()
    load_st_s = time.perf_counter() - t0
    check(isinstance(lg.tokenizer, BPETokenizer) and lg.config == ls.config,
          "GGUF dir: embedded BPE, the safetensors dir's config")
    text = " ".join("".join(chr(97 + int(x)) for x in rng.integers(0, 26, n))
                    for n in rng.integers(2, 9, 300))
    ids = lg.encode_prompt(text)
    check(lg.tokenizer.decode(ids) == text, "GGUF BPE decodes what it encodes")

    def leaves(p, pre=""):
        for k, v in p.items():
            yield from (leaves(v, pre + k + ".") if isinstance(v, dict) else [(pre + k, v)])
    pg, ps = dict(leaves(lg.params)), dict(leaves(ls.params))
    check(pg.keys() == ps.keys() and all(torch.equal(pg[k], ps[k]) for k in pg),
          "GGUF params equal the dequantized safetensors params")
    f0 = _counts()[0]
    out_g, out_s = prefill_logits(lg, ids), prefill_logits(ls, ids)
    check(_counts()[0] - f0 == 2 * L, "GGUF and safetensors prefills take flash")
    check(torch.equal(out_g, out_s) and bool(torch.isfinite(out_g).all()),
          "GGUF first-prefill logits equal the safetensors ones")
    row = {"serve": "gguf", "layers": L, "prompt_tokens": len(ids),
           "gguf_gb": (gd / "model.gguf").stat().st_size / 1e9, "write_s": write_s,
           "load_gguf_s": load_gguf_s, "load_safetensors_s": load_st_s,
           "logits_max_abs_diff": (out_g - out_s).abs().max().item()}
    print(json.dumps(row))
    del lg, ls
    torch.cuda.empty_cache()
    return row


def phase_serve(d: Path, tmp: Path) -> None:
    """Phase 9: the continuous engine and speculative decoding in bf16 and
    int4, the HTTP server (over d's first SERVE_LAYERS layers), and a GGUF
    dir."""
    d = layers_view(d, tmp / f"llama-3.2-1b-{SERVE_LAYERS}-layers-serve", SERVE_LAYERS)
    for quantize in (None, "int4"):
        serve_engine(d, quantize)
    for quantize in (None, "int4"):
        serve_speculative(d, tmp, quantize)
    serve_http(d)
    serve_gguf(tmp)


# ---------------------------------------------------------------------------
# phases 10 and 11: the encoder-decoder family
# ---------------------------------------------------------------------------

# the public config.json values (the keys the loaders read) of the registry's
# seq2seq and speech defaults
DISTILBART_CNN = {
    "model_type": "bart", "architectures": ["BartForConditionalGeneration"],
    "vocab_size": 50264, "d_model": 1024, "encoder_layers": 12, "decoder_layers": 6,
    "encoder_attention_heads": 16, "decoder_attention_heads": 16,
    "encoder_ffn_dim": 4096, "decoder_ffn_dim": 4096, "max_position_embeddings": 1024,
    "activation_function": "gelu", "scale_embedding": False, "bos_token_id": 0,
    "pad_token_id": 1, "eos_token_id": 2, "decoder_start_token_id": 2,
    "forced_bos_token_id": 0, "forced_eos_token_id": 2,
    "task_specific_params": {"summarization": {
        "early_stopping": True, "length_penalty": 2.0, "max_length": 142,
        "min_length": 56, "no_repeat_ngram_size": 3, "num_beams": 4}},
}
FLAN_T5_BASE = {
    "model_type": "t5", "architectures": ["T5ForConditionalGeneration"],
    "vocab_size": 32128, "d_model": 768, "d_kv": 64, "d_ff": 2048, "num_layers": 12,
    "num_decoder_layers": 12, "num_heads": 12, "relative_attention_num_buckets": 32,
    "relative_attention_max_distance": 128, "feed_forward_proj": "gated-gelu",
    "layer_norm_epsilon": 1e-6, "tie_word_embeddings": False,
    "decoder_start_token_id": 0, "eos_token_id": 1, "pad_token_id": 0,
    "task_specific_params": {
        "summarization": {"early_stopping": True, "length_penalty": 2.0, "max_length": 200,
                          "min_length": 30, "no_repeat_ngram_size": 3, "num_beams": 4,
                          "prefix": "summarize: "},
        "translation_en_to_de": {"early_stopping": True, "max_length": 300, "num_beams": 4,
                                 "prefix": "translate English to German: "}},
}
WHISPER_SMALL = {
    "model_type": "whisper", "architectures": ["WhisperForConditionalGeneration"],
    "vocab_size": 51865, "d_model": 768, "encoder_layers": 12, "decoder_layers": 12,
    "encoder_attention_heads": 12, "decoder_attention_heads": 12,
    "encoder_ffn_dim": 3072, "decoder_ffn_dim": 3072, "num_mel_bins": 80,
    "max_source_positions": 1500, "max_target_positions": 448, "bos_token_id": 50257,
    "eos_token_id": 50257, "pad_token_id": 50257, "decoder_start_token_id": 50258,
}
WHISPER_LARGE_V3 = {   # openai/whisper-large-v3 (phase 19: the decoder's first 4 layers)
    **WHISPER_SMALL, "vocab_size": 51866, "d_model": 1280, "encoder_layers": 32,
    "decoder_layers": 32, "encoder_attention_heads": 20, "decoder_attention_heads": 20,
    "encoder_ffn_dim": 5120, "decoder_ffn_dim": 5120, "num_mel_bins": 128,
    "pad_token_id": 50256,
}
WHISPER_LARGE_V3_DECODER_LAYERS = 4
# (registry name, public source, config, special tokens {text: id}, post-processor)
SEQ2SEQ = (
    ("distilbart-cnn", "sshleifer/distilbart-cnn-12-6", DISTILBART_CNN,
     {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "<mask>": 50263}, "<s> $A </s>"),
    ("flan-t5-base", "google/flan-t5-base", FLAN_T5_BASE,
     {"<pad>": 0, "</s>": 1, "<unk>": 2}, "$A </s>"),
)
WHISPER_LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms cs ro da hu "
    "ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn et mk br eu is hy ne mn "
    "bs kk sq sw gl mr pa si km sn yo so af oc ka be tg sd gu am yi lo uz fo ht ps tk nn "
    "mt sa lb my bo tl mg as tt haw ln ha ba jw su").split()
# bf16 against f32 on the card. BART renormalizes every layer: the embed phase's
# bound. T5's residual stream is never normalized between its 12 layers and its
# scores are unscaled: at flan-t5-base's widths bf16 reads ~0.9955 against f32,
# on the CPU as on the card and with cuBLAS's reduced-precision reduction off
# (this phase prints all three), so 0.999 cannot hold there; 0.99 still fails
# the planted T5 faults (an encoder bias built unidirectional, scores scaled
# by d_kv ** -0.5), which read ~0.2
S2S_COS_MIN = {"bart": 0.999, "t5": 0.99}
S2S_PROFILE_STEPS = 16     # the profiled call's max_length: a short trace
S2S_STATES_ATOL, S2S_STATES_RTOL = 2e-4, 1e-3   # f32 card against f32 CPU (embed's)
S2S_LOGITS_ATOL = 1e-3     # f32 logits: card against CPU, padded against unpadded
# the f32 loops are compared over this many steps: the host loop sums beam
# scores in f64 and the device loop in f32 (as the JAX package's two loops
# do), and the f32 sums drift by ~1e-4 over 142 steps, within reach of the
# gap between the k-th and (k+1)-th candidate at some step
S2S_LOOP_STEPS = 64
S2S_FAULTS = ("self_cache_not_reordered", "cross_padding_bias_dropped",
              "t5_decoder_bias_bidirectional", "t5_encoder_bias_unidirectional",
              "t5_attention_scaled")
S2S_TRACE_ATOL = 1e-5      # the two loops' per-step logits (the same f32 ops)
WHISPER_FLASH_COS_MIN = 0.999   # encoder states with flash against plain, bf16
WHISPER_FLASH_REF_TOL = 1.5e-2  # phase 2's bound at the encoder's shape, of max|out|
WHISPER_FLASH_CONTROLS = {"causal": {"causal": True}, "last key dropped": {"kv_len": 1499}}
WHISPER_MEL_ATOL = 2e-4         # the JAX test's bound against HF's extractor
WHISPER_TIE_BAND = SERVE_TIE_BAND
WHISPER_CHECK_STEPS = 32        # tokens per row held to the tie band
WHISPER_FAULTS = ("encoder_flash_causal", "decoder_positions_shifted")


def seq2seq_modules(c: dict) -> dict:
    """module name -> (kind, shape) of the HF checkpoint layout of config c:
    "emb" a table, "lin" a linear with bias, "w" one without, "norm" a
    LayerNorm (ones and zeros), "rms" an RMSNorm weight (ones), "table" a
    T5 relative-position table, "head" an output head's table, "zeros" a
    zero vector."""
    mt = c["model_type"]
    out = {}
    if mt == "t5":
        d, inner, ff = c["d_model"], c["num_heads"] * c["d_kv"], c["d_ff"]

        def attn(p):
            return {p + "q": ("w", (inner, d)), p + "k": ("w", (inner, d)),
                    p + "v": ("w", (inner, d)), p + "o": ("w", (d, inner))}

        def ffn(p):
            return {p + "wi_0": ("w", (ff, d)), p + "wi_1": ("w", (ff, d)),
                    p + "wo": ("w", (d, ff))}
        out = {"shared": ("emb", (c["vocab_size"], d)),
               "lm_head": ("head", (c["vocab_size"], d)),
               "encoder.final_layer_norm": ("rms", (d,)),
               "decoder.final_layer_norm": ("rms", (d,))}
        for side in ("encoder", "decoder"):
            out[f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias"] = \
                ("table", (c["relative_attention_num_buckets"], c["num_heads"]))
        for i in range(c["num_layers"]):
            p = f"encoder.block.{i}.layer."
            out.update({**attn(p + "0.SelfAttention."), p + "0.layer_norm": ("rms", (d,)),
                        **ffn(p + "1.DenseReluDense."), p + "1.layer_norm": ("rms", (d,))})
        for i in range(c["num_decoder_layers"]):
            p = f"decoder.block.{i}.layer."
            out.update({**attn(p + "0.SelfAttention."), p + "0.layer_norm": ("rms", (d,)),
                        **attn(p + "1.EncDecAttention."), p + "1.layer_norm": ("rms", (d,)),
                        **ffn(p + "2.DenseReluDense."), p + "2.layer_norm": ("rms", (d,))})
        return out
    d = c["d_model"]
    whisper = mt == "whisper"
    k_kind = "w" if whisper else "lin"          # Whisper's k_proj has no bias

    def attn(p):
        return {p + "q_proj": ("lin", (d, d)), p + "k_proj": (k_kind, (d, d)),
                p + "v_proj": ("lin", (d, d)), p + "out_proj": ("lin", (d, d))}

    def block(p, F, cross):
        m = {**attn(p + "self_attn."), p + "self_attn_layer_norm": ("norm", (d,)),
             p + "fc1": ("lin", (F, d)), p + "fc2": ("lin", (d, F)),
             p + "final_layer_norm": ("norm", (d,))}
        if cross:
            m.update({**attn(p + "encoder_attn."), p + "encoder_attn_layer_norm": ("norm", (d,))})
        return m
    pre = "model."
    if whisper:
        out = {pre + "encoder.conv1": ("lin3", (d, c["num_mel_bins"], 3)),
               pre + "encoder.conv2": ("lin3", (d, d, 3)),
               pre + "encoder.embed_positions": ("emb", (c["max_source_positions"], d)),
               pre + "encoder.layer_norm": ("norm", (d,)),
               # the tied head, and the positions at the tokens' scale
               pre + "decoder.embed_tokens": ("head", (c["vocab_size"], d)),
               pre + "decoder.embed_positions": ("head", (c["max_target_positions"], d)),
               pre + "decoder.layer_norm": ("norm", (d,))}
    else:
        P = c["max_position_embeddings"] + 2      # BART's +2 position offset
        out = {pre + "shared": ("head", (c["vocab_size"], d)),   # tied head
               pre + "encoder.embed_positions": ("emb", (P, d)),
               pre + "decoder.embed_positions": ("emb", (P, d)),
               pre + "encoder.layernorm_embedding": ("norm", (d,)),
               pre + "decoder.layernorm_embedding": ("norm", (d,)),
               "final_logits_bias": ("zeros", (1, c["vocab_size"]))}
    for i in range(c["encoder_layers"]):
        out.update(block(f"{pre}encoder.layers.{i}.", c["encoder_ffn_dim"], False))
    for i in range(c["decoder_layers"]):
        out.update(block(f"{pre}decoder.layers.{i}.", c["decoder_ffn_dim"], True))
    return out


def write_encdec_dir(d: Path, c: dict, seed: int = 0) -> None:
    """config.json and model.safetensors of random bf16 weights in config
    c's checkpoint layout: N(0, 0.02) from a seeded generator on the card,
    norms ones (and zeros); T5's relative-position tables N(0, 1) (trained
    tables are of that order; at 0.02 the bias would vanish beside the
    unscaled scores) and the output heads (BART's shared table, T5's
    lm_head, Whisper's token table and its decoder positions) N(0, 0.2):
    logits of std ~6, peaked as a trained model's are, where 0.02 gives
    near-uniform ones whose candidates tie."""
    import torch
    from kjarni_tpu_torch.weights.safetensors_loader import save_file
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(shape, std=0.02):
        return (torch.randn(*shape, generator=g, device="cuda") * std
                ).to(torch.bfloat16).cpu()

    tensors = {}
    for name, (kind, shape) in seq2seq_modules(c).items():
        if kind in ("norm", "rms"):
            tensors[name + ".weight"] = torch.ones(shape, dtype=torch.bfloat16)
            if kind == "norm":
                tensors[name + ".bias"] = torch.zeros(shape, dtype=torch.bfloat16)
        elif kind == "zeros":
            tensors[name] = torch.zeros(shape, dtype=torch.bfloat16)
        else:
            tensors[name + ".weight"] = rnd(shape, {"table": 1.0, "head": 0.2}.get(kind, 0.02))
            if kind in ("lin", "lin3"):
                tensors[name + ".bias"] = rnd(shape[:1])
    d.mkdir(parents=True, exist_ok=True)
    save_file(tensors, d / "model.safetensors")
    (d / "config.json").write_text(json.dumps(c))


def write_word_tokenizer(path: Path, vocab_size: int, specials: dict,
                         single: str) -> None:
    """A word-level tokenizer.json over the whole vocabulary: the words w<id>
    at every id but the specials', the specials at theirs, and the
    post-processor template `single` (BART's "<s> $A </s>", T5's "$A </s>")."""
    from tokenizers import AddedToken, Tokenizer, models, normalizers, pre_tokenizers, processors
    words = [f"w{i}" for i in range(vocab_size)]
    for text, i in specials.items():
        words[i] = text
    unk = "<unk>"
    tk = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token=unk))
    tk.normalizer = normalizers.Lowercase()
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    tk.add_special_tokens([AddedToken(t, special=True, normalized=False) for t in specials])
    tk.post_processor = processors.TemplateProcessing(
        single=single, special_tokens=[(t, i) for t, i in specials.items() if t in single])
    tk.save(str(path))


def _words(n: int, lo: int, hi: int, seed: int) -> str:
    """n random words w<id> (ids lo..hi-1, one token each)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return " ".join(f"w{i}" for i in torch.randint(lo, hi, (n,), generator=g).tolist())


def _s2s_forward(lm, ids, mask, dec: list, cross_mask=None):
    """(encoder states [B, S, d], logits [B, len(dec), V]) in f32 of one
    teacher-forced decoder pass over `dec` (every row) after encoding ids."""
    import torch
    fam, cfg = lm.family, lm.config
    with torch.inference_mode():
        enc, ck, cv = lm._encode_and_cross(ids, mask)
        sk, sv = fam.init_self_cache(cfg, ids.shape[0], 32, lm.dtype, lm.device)
        dec_t = torch.tensor([dec] * ids.shape[0], device=lm.device)
        logits, _, _ = fam.decode_step(lm.params, cfg, dec_t, sk, sv, ck, cv,
                                       mask if cross_mask is None else cross_mask, 0)
    return enc.float(), logits.float()


def _stages(row: dict):
    """stage(name) records the seconds since the previous stage in
    row["stage_s"][name]."""
    t = [time.perf_counter()]
    row["stage_s"] = {}

    def stage(name: str) -> None:
        now = time.perf_counter()
        row["stage_s"][name] = now - t[0]
        t[0] = now
    return stage


def _max_err(a, b) -> float:
    return (a.float().cpu() - b.float().cpu()).abs().max().item()


def _beam_trace(lm, run):
    """(run()'s result, each decode step's (pos, tokens, parents, logits) on
    the host) for one beam loop over lm's decode step."""
    import torch
    trace = []
    real = lm._step

    def step(ids, sk, sv, ck, cv, mask, pos, parents):
        logits, sk, sv = real(ids, sk, sv, ck, cv, mask, pos, parents)
        trace.append((pos, ids.reshape(-1).cpu(), parents.cpu(), logits.float().cpu()))
        return logits, sk, sv
    lm._step = step
    try:
        with torch.inference_mode():
            return run(), trace
    finally:
        del lm._step


def _trace_parts(a: list, b: list, start: int = 0):
    """The first step from `start` at which two beam traces differ (tokens,
    parents, or logits beyond S2S_TRACE_ATOL), or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if i < start:
            continue
        if x[0] != y[0] or not (x[1].equal(y[1]) and x[2].equal(y[2])) \
                or (x[3] - y[3]).abs().max().item() > S2S_TRACE_ATOL:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


@contextlib.contextmanager
def s2s_fault(name: str):
    """Within the block one fault is planted (S2S_FAULTS); the cross padding
    fault is planted by the caller, which passes an all-ones cross mask."""
    from kjarni_tpu_torch.models import seq2seq_lm
    from kjarni_tpu_torch.models import t5 as kt5
    saved = seq2seq_lm.reorder_cache, kt5.position_bias, kt5.attention
    real_bias, real_attention = kt5.position_bias, kt5.attention
    if name == "self_cache_not_reordered":
        seq2seq_lm.reorder_cache = lambda cache, parents: cache
    elif name in ("t5_decoder_bias_bidirectional", "t5_encoder_bias_unidirectional"):
        both = name == "t5_decoder_bias_bidirectional"
        kt5.position_bias = lambda table, q0, sq, sk, bidirectional, nb, md: real_bias(
            table, q0, sq, sk, both, nb, md)
    elif name == "t5_attention_scaled":   # d_kv ** -0.5 where T5 takes 1.0
        kt5.attention = lambda q, k, v, bias=None, scale=None: real_attention(q, k, v, bias)
    try:
        yield
    finally:
        seq2seq_lm.reorder_cache, kt5.position_bias, kt5.attention = saved


def run_seq2seq(name: str, source: str, d: Path, seed: int) -> dict:
    """One seq2seq registry default through its task API on the card (bf16),
    then the checks against f32 on the card and on the CPU and the beam
    loops against each other in f32, each with its planted faults; one JSON
    line."""
    import numpy as np
    import torch
    from kjarni_tpu_torch import Seq2SeqOverrides, Summarizer, Translator
    from kjarni_tpu_torch.models.seq2seq_lm import Seq2SeqLM
    bart = name == "distilbart-cnn"
    row = {"model": name, "source": source,
           "task": "summarize" if bart else "translate"}
    stage = _stages(row)
    t0 = time.perf_counter()
    api = Summarizer(str(d)) if bart else Translator(str(d))
    lm = api._gen.lm
    torch.cuda.synchronize()
    row["load_s"] = time.perf_counter() - t0
    check(lm.device.type == "cuda" and lm.dtype == torch.bfloat16,
          f"{name}: the task's model runs bf16 on the card")
    # words below BART's <mask> (the last id) and T5's 100 sentinel ids
    hi = lm.config.vocab_size - (1 if bart else 128)
    text = _words(800 if bart else 100, 10, hi, seed)
    if bart:
        def call():
            return api.summarize(text)
    else:
        def call():
            return api.translate(text, "en", "de")
    steps = [0]
    real_step = lm._step

    def counted_step(*a):
        steps[0] += 1
        return real_step(*a)
    lm._step = counted_step
    ids, mask = lm._encode_input(text)
    row["input_tokens"] = int(mask.sum())
    out = call()                                   # warm-up, and the output
    check(isinstance(out, str), f"{name}: text out")
    torch.cuda.reset_peak_memory_stats()
    allocated = torch.cuda.memory_allocated()
    runs = []
    for _ in range(3):
        steps[0] = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        again = call()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t)
        check(again == out, f"{name}: a repeated call gives the same text")
    row.update(call_s=statistics.median(runs), call_s_runs=runs, decode_steps=steps[0],
               beams=lm.beam_config(task="summarization" if bart else None)[0].num_beams,
               output_words=len(out.split()))
    row["decode_steps_per_s"] = steps[0] / row["call_s"]
    row["peak_mem_gb"] = (torch.cuda.max_memory_allocated() - allocated) / 1e9
    stage("calls")
    if bart:
        t = time.perf_counter()
        pieces = list(api.stream(text))
        row["stream_s"] = time.perf_counter() - t
        # the stream takes the host loop, which breaks exact bf16 ties its own
        # way: the loops are held equal in f32 below
        check(all(isinstance(p, str) for p in pieces), f"{name}: stream yields text")
        row.update(stream_pieces=len(pieces), stream_equals_summary="".join(pieces) == out)
    del lm._step
    enc_prof = profile_call(lambda: lm._encode_and_cross(ids, mask), top=3)
    row["encoder_device_ms"] = enc_prof["profile_kernel_ms"]
    # a call of S2S_PROFILE_STEPS decode steps, profiled and not: the
    # profiler sorts a whole call's ~10^5 kernels for minutes
    short = Seq2SeqOverrides(max_length=S2S_PROFILE_STEPS)
    prof_call = (lambda: api.summarize(text, short)) if bart else \
        (lambda: api.translate(text, "en", "de", short))
    prof = profile_call(prof_call, top=5, ops=False)
    row.update({k: prof[k] for k in ("profile_wall_ms", "profile_kernel_ms",
                                     "profile_top_kernels")})
    row["device_busy_share"] = prof["profile_kernel_ms"] / host_ms(prof_call, iters=2)
    stage("profile")

    # bf16 against f32 on the card: encoder states and first-step logits
    f32 = Seq2SeqLM(d, dtype="f32")
    start = [lm.config.decoder_start_token_id]
    e16, l16 = _s2s_forward(lm, ids, mask, start)
    e32, l32 = _s2s_forward(f32, ids, mask, start)
    real = mask[0].bool()
    cos_states = torch.nn.functional.cosine_similarity(e16[0, real], e32[0, real],
                                                       dim=-1).min().item()
    cos_logits = _cosine(l16, l32)
    row.update(min_state_cosine_bf16_vs_f32=cos_states, logits_cosine_bf16_vs_f32=cos_logits)
    faults = {}
    if not bart:
        def cosines(ef, lf, e_ref=e32, l_ref=l32):
            rows = real.to(ef.device)
            return (torch.nn.functional.cosine_similarity(ef[0, rows], e_ref[0, rows],
                                                          dim=-1).min().item(),
                    _cosine(lf, l_ref))
        # the same with cuBLAS's reduced-precision bf16 reduction off, and
        # the planted faults the bound must reject
        mm = torch.backends.cuda.matmul
        reduced = mm.allow_bf16_reduced_precision_reduction
        mm.allow_bf16_reduced_precision_reduction = False
        try:
            row["cosines_bf16_vs_f32_full_reduction"] = cosines(
                *_s2s_forward(lm, ids, mask, start))
        finally:
            mm.allow_bf16_reduced_precision_reduction = reduced
        for fault in ("t5_encoder_bias_unidirectional", "t5_attention_scaled"):
            with s2s_fault(fault):
                faults[fault] = min(cosines(*_s2s_forward(lm, ids, mask, start)))
    stage("bf16_vs_f32")
    cos_min = S2S_COS_MIN[lm.config.arch]
    check(cos_states >= cos_min and cos_logits >= cos_min,
          f"{name}: bf16 vs f32 cosine (states {cos_states}, logits {cos_logits}) "
          f">= {cos_min}")
    for fault, cos in faults.items():
        check(cos < cos_min, f"{name}: planted fault {fault} reads cosine {cos}, "
                             f"outside the {cos_min} bound")

    # f32 on the card against f32 on the CPU: 128 words, 24 decoder tokens
    cpu = Seq2SeqLM(d, dtype="f32", device="cpu")
    if not bart:   # and the bf16 check's reading taken on the CPU instead
        cpu16 = Seq2SeqLM(d, dtype="bf16", device="cpu")
        row["cosines_bf16_vs_f32_cpu"] = cosines(
            *_s2s_forward(cpu16, ids.cpu(), mask.cpu(), start),
            *_s2s_forward(cpu, ids.cpu(), mask.cpu(), start))
        del cpu16
    short = _words(128, 10, hi, seed + 1)
    dec = start + [int(t) for t in torch.randint(10, hi, (23,),
                                                 generator=torch.Generator().manual_seed(seed))]
    ids_c, mask_c = f32._encode_input(short)
    ec, lc = _s2s_forward(f32, ids_c, mask_c, dec)
    eh, lh = _s2s_forward(cpu, ids_c.cpu(), mask_c.cpu(), dec)
    rc = mask_c[0].bool().cpu()
    states_ok = bool(torch.allclose(ec[0, rc.to(ec.device)].cpu(), eh[0, rc],
                                    atol=S2S_STATES_ATOL, rtol=S2S_STATES_RTOL))
    row["f32_card_vs_cpu_states_max_abs_err"] = _max_err(ec[0, rc.to(ec.device)], eh[0, rc])
    row["f32_card_vs_cpu_logits_max_abs_err"] = _max_err(lc, lh)
    check(states_ok, f"{name}: f32 card vs CPU encoder states within atol "
                     f"{S2S_STATES_ATOL} rtol {S2S_STATES_RTOL}")
    check(row["f32_card_vs_cpu_logits_max_abs_err"] <= S2S_LOGITS_ATOL,
          f"{name}: f32 card vs CPU logits {row['f32_card_vs_cpu_logits_max_abs_err']} "
          f"<= {S2S_LOGITS_ATOL}")
    logit_faults = {}
    if not bart:
        with s2s_fault("t5_decoder_bias_bidirectional"):
            _, lf = _s2s_forward(f32, ids_c, mask_c, dec)
        logit_faults["t5_decoder_bias_bidirectional"] = _max_err(lf, lh)
    else:
        # a padded row against the same input alone, unpadded
        other = _words(300, 10, hi, seed + 2)
        b_ids, b_mask = f32.tokenizer.encode_batch([other, short], max_len=1022)
        b_ids = torch.from_numpy(np.asarray(b_ids, np.int64)).cuda()
        b_mask = torch.from_numpy(np.asarray(b_mask, np.int64)).cuda()
        n = int(b_mask[1].sum())
        check(n < b_ids.shape[1], f"{name}: the second row is padded")
        _, alone = _s2s_forward(f32, b_ids[1:, :n], b_mask[1:, :n], dec[:8])
        _, padded = _s2s_forward(f32, b_ids, b_mask, dec[:8])
        row["padded_vs_unpadded_logits_max_abs_err"] = _max_err(padded[1], alone[0])
        check(row["padded_vs_unpadded_logits_max_abs_err"] <= S2S_LOGITS_ATOL,
              f"{name}: a padded row's logits equal its unpadded run's")
        _, lf = _s2s_forward(f32, b_ids, b_mask, dec[:8], cross_mask=torch.ones_like(b_mask))
        logit_faults["cross_padding_bias_dropped"] = _max_err(lf[1], alone[0])
    stage("f32_vs_cpu_and_padding")
    for fault, err in logit_faults.items():
        check(err > S2S_LOGITS_ATOL, f"{name}: planted fault {fault} reads {err}, "
                                     f"outside the {S2S_LOGITS_ATOL} bound")
    faults.update(logit_faults)

    # the device beam loop against the host loop over one decode step, in
    # f32: the same tokens and, step by step, the same decode inputs and logits
    bs, _ = f32.beam_config(task="summarization" if bart else None)
    bs = dataclasses.replace(bs, max_length=S2S_LOOP_STEPS)
    e_ids, e_mask = f32._encode_input(text)
    fused, fused_trace = _beam_trace(f32, lambda: f32._generate_fused(bs, e_ids, e_mask))
    host, host_trace = _beam_trace(f32, lambda: f32._generate_host(bs, e_ids, e_mask))
    # at step 0 only beam 0 is live. With a forced BOS every other candidate
    # ties at the mask value, and the loops fill the k - 1 dead rows of step 1
    # differently (the host masks with -inf, the device with -1e9, as the JAX
    # package's loops do); from step 2 every row descends from the BOS in both
    start = 2 if bs.forced_bos_token_id is not None else 0
    parted = _trace_parts(fused_trace, host_trace, start)
    row.update(f32_beam_steps=len(fused_trace), f32_beam_tokens=len(fused),
               f32_loops_part_at_step=parted)
    check(fused == host and parted is None,
          f"{name}: f32 device beam loop equals the host loop (tokens; steps from "
          f"{parted})")
    with s2s_fault("self_cache_not_reordered"):
        faulty, faulty_trace = _beam_trace(
            f32, lambda: f32._generate_fused(bs, e_ids, e_mask))
    faults["self_cache_not_reordered"] = _trace_parts(faulty_trace, host_trace, start)
    row["fault_tokens_equal_host"] = faulty == host
    check(faults["self_cache_not_reordered"] is not None,
          f"{name}: planted fault self_cache_not_reordered parts the loops")
    stage("beam_loops")
    row["faults"] = faults
    print(json.dumps(row))
    del api, lm, f32, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_seq2seq() -> list:
    import torch
    counts = _counts()
    rows = []
    with tempfile.TemporaryDirectory(prefix="kjarni_s2s_") as tmp:
        for i, (name, source, cfg, specials, single) in enumerate(SEQ2SEQ):
            d = Path(tmp) / name
            t0 = time.perf_counter()
            write_encdec_dir(d, cfg, seed=40 + i)
            write_word_tokenizer(d / "tokenizer.json", cfg["vocab_size"], specials, single)
            print(f"{name}: model dir written: {time.perf_counter() - t0:.1f} s, "
                  f"{(d / 'model.safetensors').stat().st_size / 1e9:.2f} GB")
            rows.append(run_seq2seq(name, source, d, seed=50 + i))
            torch.cuda.empty_cache()
    planted = {f for r in rows for f in r["faults"]}
    check(planted == set(S2S_FAULTS), f"every seq2seq fault planted: {sorted(planted)}")
    check(_counts() == counts, f"the seq2seq phase launched no hand-written kernel "
                               f"(flash, int4: {counts} -> {_counts()})")
    return rows


def whisper_specials(languages: int = len(WHISPER_LANGUAGES)) -> dict:
    """Whisper's special tokens at their fixed ids: whisper-small's 99
    languages, or large-v3's 100 (<|yue|> added), which move every id after
    them up by one."""
    langs = (*WHISPER_LANGUAGES, "yue")[:languages]
    sp = {"<|endoftext|>": 50257, "<|startoftranscript|>": 50258}
    sp.update({f"<|{lang}|>": 50259 + i for i, lang in enumerate(langs)})
    after = ("<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>",
             "<|nocaptions|>", "<|notimestamps|>")
    sp.update({t: 50259 + len(langs) + i for i, t in enumerate(after)})
    ts = 50259 + len(langs) + len(after)
    sp.update({f"<|{0.02 * i:.2f}|>": ts + i for i in range(1501)})
    return sp


def _speech(seconds: float, seed: int):
    """A synthetic signal at 16 kHz: a few drifting tones and noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    x = sum(a * np.sin(2 * np.pi * (f + 5 * np.sin(0.3 * t)) * t)
            for a, f in zip(rng.uniform(0.05, 0.2, 4), rng.uniform(100, 3000, 4)))
    return (x + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


@contextlib.contextmanager
def whisper_fault(wm, name: str):
    """Within the block one WHISPER_FAULTS fault is planted in model wm: the
    encoder's flash called with causal=True, or the decoder's position table
    shifted by one row (position p reads p - 1's embedding)."""
    import torch
    from kjarni_tpu_torch.models import whisper as kwhisper
    saved = kwhisper.flash_attention, wm.params
    if name == "encoder_flash_causal":
        real = kwhisper.flash_attention
        kwhisper.flash_attention = lambda q, k, v, **kw: real(q, k, v, **{**kw, "causal": True})
    else:
        wm.params = {**wm.params, "dec_pos": torch.roll(wm.params["dec_pos"], 1, 0)}
    try:
        yield
    finally:
        kwhisper.flash_attention, wm.params = saved


def _wave_margins(wm, chunks, out, prompt, allow) -> list:
    """Each batched row's first WHISPER_CHECK_STEPS tokens against a
    teacher-forced serial forward of its chunk (B = 1 encode, one decoder
    pass over prompt + row): max(allowed logits) - logit[token] per token."""
    import torch
    from kjarni_tpu_torch.models import whisper as kwhisper
    from kjarni_tpu_torch.models.whisper_transcriber import EOT_TOKEN, audio_pcm16
    margins = []
    counts = _counts()
    with torch.inference_mode():
        for j, chunk in enumerate(chunks):
            row = [int(t) for t in out[j][:WHISPER_CHECK_STEPS]]
            if EOT_TOKEN in row:
                row = row[:row.index(EOT_TOKEN) + 1]
            ck, cv = wm._encode_chunk(audio_pcm16(chunk))
            ids = torch.tensor([prompt + row[:-1]], device=wm.device)
            sk, sv = wm._new_cache(1, ids.shape[1])
            logits, _, _ = kwhisper.decode_step(wm.params, wm.config, ids, sk, sv, ck, cv,
                                                None, 0)
            ref = torch.where(allow, logits[0, len(prompt) - 1:].float(), float("-inf")).cpu()
            margins += _margins(ref, row)
    _restore(counts)
    return margins


def phase_whisper() -> dict:
    """whisper-small's widths through Transcriber on the card; see the module
    docstring (phase 11)."""
    import numpy as np
    import torch
    from kjarni_tpu_torch import Transcriber
    from kjarni_tpu_torch.audio.loader import write_wav
    from kjarni_tpu_torch.audio.mel import log_mel_spectrogram
    from kjarni_tpu_torch.models import whisper as kwhisper
    from kjarni_tpu_torch.models import whisper_transcriber as wt
    from kjarni_tpu_torch.ops.kernels.flash_attention import flash_attention
    c = WHISPER_SMALL
    row = {"model": "whisper-small", "source": "openai/whisper-small"}
    stage = _stages(row)
    with tempfile.TemporaryDirectory(prefix="kjarni_whisper_") as tmp:
        d = Path(tmp) / "whisper-small"
        t0 = time.perf_counter()
        write_encdec_dir(d, c, seed=60)
        write_tokenizer(d / "tokenizer.json", c["vocab_size"], whisper_specials())
        print(f"whisper-small: model dir written: {time.perf_counter() - t0:.1f} s, "
              f"{(d / 'model.safetensors').stat().st_size / 1e9:.2f} GB")
        a30, a240 = _speech(30.0, 61), _speech(240.0, 62)
        wav30, wav240 = Path(tmp) / "a30.wav", Path(tmp) / "a240.wav"
        write_wav(wav30, a30, 16000)
        write_wav(wav240, a240, 16000)

        stage("write")
        t0 = time.perf_counter()
        tr = Transcriber(str(d))
        wm = tr._model
        torch.cuda.synchronize()
        row["load_s"] = time.perf_counter() - t0
        check(wm.device.type == "cuda" and wm.dtype == torch.bfloat16 and wm.use_flash,
              "whisper: bf16 on the card, the encoder on flash")
        encodes = [0]
        real_encode = kwhisper.encode

        def counted_encode(*a, **kw):
            encodes[0] += 1
            return real_encode(*a, **kw)
        kwhisper.encode = counted_encode
        torch.cuda.reset_peak_memory_stats()
        f0 = flash_attention.launches

        def run(what, seconds, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            row[what] = {"audio_s": seconds, "wall_s": secs, "rtf": seconds / secs}
            return res

        r30 = run("serial_30s", 30.0, lambda: tr.transcribe_file(wav30))
        r240 = run("batched_240s", 240.0, lambda: tr.transcribe_file(wav240))
        pieces = run("stream_30s", 30.0, lambda: list(tr.stream_file(wav30)))
        auto = Transcriber(str(d), language="auto")
        run("auto_30s", 30.0, lambda: auto.transcribe_file(wav30))
        ts = Transcriber(str(d), timestamps=True)
        rts = run("timestamps_30s", 30.0, lambda: ts.transcribe_file(wav30))
        del auto, ts
        kwhisper.encode = real_encode
        launched = flash_attention.launches - f0
        row.update(encode_calls=encodes[0], flash_launches=launched,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   words_30s=len(r30.text.split()), words_240s=len(r240.text.split()),
                   stream_pieces=len(pieces), timestamp_segments=len(rts.segments))
        check(launched == c["encoder_layers"] * encodes[0],
              f"whisper: {launched} flash launches, 12 per encode call x {encodes[0]}")
        check(len(r240.segments) >= 1 or not r240.text.strip(), "whisper: segments")
        check(abs(r240.duration - 240.0) < 0.01, f"whisper: duration {r240.duration}")
        stage("main_path")
        main_counts = _counts()   # the Transcriber calls' launches alone

        # decode tok/s of the 240 s wave alone
        cfg = wm.build_prompt_tokens(tr.config)
        chunks = wm.chunk_audio(a240)
        pcm = wt.audio_pcm16(np.stack(chunks))
        ck, cv = wm._encode_chunks(pcm)
        cache_len, max_steps, allow = wm._plan(cfg, tr.config)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, _ = wm._decode_loop_b(cfg, ck, cv, allow, cache_len, max_steps)
        dt = time.perf_counter() - t
        gen = sum(min(len(r), (list(r) + [wt.EOT_TOKEN]).index(wt.EOT_TOKEN) + 1) for r in out)
        row["wave"] = {"B": len(chunks), "decode_s": dt, "tokens": int(gen),
                       "decode_tok_per_s": gen / dt, "steps": int(out.shape[1])}
        # a serial chunk of 16 tokens, profiled and not
        short = wt.WhisperTranscriberConfig(max_tokens_per_chunk=16)
        prof = profile_call(lambda: wm.transcribe(a30, short), top=5, ops=False)
        row.update({k: prof[k] for k in ("profile_wall_ms", "profile_kernel_ms",
                                         "profile_top_kernels")})
        row["device_busy_share"] = prof["profile_kernel_ms"] / host_ms(
            lambda: wm.transcribe(a30, short), iters=2)
        stage("profile")

        # the mel on the card against the CPU's
        mel_card = log_mel_spectrogram(torch.from_numpy(chunks[0]).cuda(), wm.mel_config).cpu()
        mel_cpu = log_mel_spectrogram(torch.from_numpy(chunks[0]), wm.mel_config)
        row["mel_card_vs_cpu_max_abs_err"] = _max_err(mel_card, mel_cpu)
        check(row["mel_card_vs_cpu_max_abs_err"] <= WHISPER_MEL_ATOL,
              f"whisper: mel card vs CPU {row['mel_card_vs_cpu_max_abs_err']} "
              f"<= {WHISPER_MEL_ATOL}")

        # the encoder with flash against the plain attention, bf16, B = 1 and 8;
        # then the time of each per wave
        enc_ms, cos = {}, {}
        for B in (1, len(chunks)):
            mel = log_mel_spectrogram(wt._dequant_pcm(torch.from_numpy(pcm[:B]).cuda()),
                                      wm.mel_config).to(wm.dtype)
            with torch.inference_mode():
                f1 = flash_attention.launches
                hf = kwhisper.encode(wm.params, wm.config, mel, use_flash=True)
                check(flash_attention.launches - f1 == c["encoder_layers"],
                      "whisper: 12 flash launches per encode call")
                hp = kwhisper.encode(wm.params, wm.config, mel, use_flash=False)
                cos[f"B={B}"] = torch.nn.functional.cosine_similarity(
                    hf.float(), hp.float(), dim=-1).min().item()
                with whisper_fault(wm, "encoder_flash_causal"):
                    hc = kwhisper.encode(wm.params, wm.config, mel, use_flash=True)
                cos[f"B={B} fault encoder_flash_causal"] = \
                    torch.nn.functional.cosine_similarity(hc.float(), hp.float(),
                                                          dim=-1).min().item()
                for flash in (True, False):
                    enc_ms[f"B={B} {'flash' if flash else 'plain'}"] = cuda_ms(
                        lambda: kwhisper.encode(wm.params, wm.config, mel, use_flash=flash),
                        iters=3)
            del hf, hp, hc, mel
            torch.cuda.empty_cache()
        row.update(encoder_flash_vs_plain_min_cosine=cos, encoder_ms=enc_ms)
        stage("mel_and_encoder")
        for key, value in cos.items():
            if "fault" in key:
                check(value < WHISPER_FLASH_COS_MIN, f"whisper: planted fault reads "
                                                     f"cosine {value} ({key})")
            else:
                check(value >= WHISPER_FLASH_COS_MIN, f"whisper: encoder flash vs "
                                                      f"plain cosine {value} ({key})")

        # bf16: each batched token within the tie band of a teacher-forced
        # serial forward, and the planted position fault outside it
        margins = _wave_margins(wm, chunks, out, cfg, allow)
        with whisper_fault(wm, "decoder_positions_shifted"):
            faulty, _ = wm._decode_loop_b(cfg, ck, cv, allow, cache_len, WHISPER_CHECK_STEPS)
        fault_margins = _wave_margins(wm, chunks, faulty, cfg, allow)
        row.update(max_margin=max(margins), fault_max_margin=max(fault_margins))
        stage("tie_band")
        check(max(margins) <= WHISPER_TIE_BAND,
              f"whisper: batched tokens within {WHISPER_TIE_BAND} logits ({max(margins)})")
        check(max(fault_margins) > WHISPER_TIE_BAND,
              f"whisper: planted fault decoder_positions_shifted reads "
              f"{max(fault_margins)}, outside the band")
        del ck, cv, tr, wm
        gc.collect()
        torch.cuda.empty_cache()

        # f32 on the card: the batched wave's greedy ids equal each chunk's
        # serial decode
        wf = wt.WhisperModel(d, dtype="f32")
        check(not wf.use_flash, "whisper f32: the plain attention")
        small = wt.WhisperTranscriberConfig(max_tokens_per_chunk=WHISPER_CHECK_STEPS)
        cache_len, max_steps, allow = wf._plan(cfg, small)
        ck, cv = wf._encode_chunks(pcm)
        outb, _ = wf._decode_loop_b(cfg, ck, cv, allow, cache_len, max_steps)
        same = 0
        for j, chunk in enumerate(chunks):
            ck1, cv1 = wf._encode_chunk(wt.audio_pcm16(chunk))
            ids, _ = wf._decode_loop(cfg, ck1, cv1, allow, cache_len, 0.0, None, max_steps)
            same += list(outb[j][:len(ids)]) == ids
        row["f32_batched_rows_equal_serial"] = f"{same}/{len(chunks)}"
        check(same == len(chunks), f"whisper f32: batched rows equal serial ({same})")
        row["faults"] = {"encoder_flash_causal": min(v for k, v in cos.items() if "fault" in k),
                         "decoder_positions_shifted": max(fault_margins)}
        check(set(row["faults"]) == set(WHISPER_FAULTS), "every whisper fault planted")
        stage("f32")
        _restore(main_counts)
        del wf, ck, cv
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# phase 12
# ---------------------------------------------------------------------------

def encoder_modules(c: dict) -> dict:
    """module name -> (kind, shape) of the HF checkpoint layout of config c:
    "emb" a table, "lin" a linear with bias, "w" one without, "norm" a
    LayerNorm (ones and zeros)."""
    mt = c["model_type"]
    out = {}
    if mt == "nomic_bert":
        H, I = c["n_embd"], c["n_inner"]
        out["embeddings.word_embeddings"] = ("emb", (c["vocab_size"], H))
        out["embeddings.token_type_embeddings"] = ("emb", (c["type_vocab_size"], H))
        out["emb_ln"] = ("norm", (H,))
        for i in range(c["n_layer"]):
            p = f"encoder.layers.{i}."
            out.update({p + "attn.Wqkv": ("w", (3 * H, H)), p + "attn.out_proj": ("w", (H, H)),
                        p + "norm1": ("norm", (H,)), p + "mlp.fc11": ("w", (I, H)),
                        p + "mlp.fc12": ("w", (I, H)), p + "mlp.fc2": ("w", (H, I)),
                        p + "norm2": ("norm", (H,))})
        return out
    if mt == "distilbert":
        H, I, pre = c["dim"], c["hidden_dim"], "distilbert."
        layers, n = [f"{pre}transformer.layer.{i}." for i in range(c["n_layers"])], {}
        for p in layers:
            n.update({p + f"attention.{x}": ("lin", (H, H))
                      for x in ("q_lin", "k_lin", "v_lin", "out_lin")})
            n.update({p + "sa_layer_norm": ("norm", (H,)), p + "ffn.lin1": ("lin", (I, H)),
                      p + "ffn.lin2": ("lin", (H, I)), p + "output_layer_norm": ("norm", (H,))})
        out = {pre + "embeddings.word_embeddings": ("emb", (c["vocab_size"], H)),
               pre + "embeddings.position_embeddings":
                   ("emb", (c["max_position_embeddings"], H)),
               pre + "embeddings.LayerNorm": ("norm", (H,)), **n,
               "pre_classifier": ("lin", (H, H)),
               "classifier": ("lin", (len(c["id2label"]), H))}
        return out
    H, I = c["hidden_size"], c["intermediate_size"]
    head = "id2label" in c                   # BertForSequenceClassification
    pre = "bert." if head else ""
    out = {pre + "embeddings.word_embeddings": ("emb", (c["vocab_size"], H)),
           pre + "embeddings.position_embeddings": ("emb", (c["max_position_embeddings"], H)),
           pre + "embeddings.token_type_embeddings": ("emb", (c["type_vocab_size"], H)),
           pre + "embeddings.LayerNorm": ("norm", (H,))}
    for i in range(c["num_hidden_layers"]):
        p = f"{pre}encoder.layer.{i}."
        out.update({p + f"attention.self.{x}": ("lin", (H, H))
                    for x in ("query", "key", "value")})
        out.update({p + "attention.output.dense": ("lin", (H, H)),
                    p + "attention.output.LayerNorm": ("norm", (H,)),
                    p + "intermediate.dense": ("lin", (I, H)),
                    p + "output.dense": ("lin", (H, I)),
                    p + "output.LayerNorm": ("norm", (H,))})
    if head:
        out["bert.pooler.dense"] = ("lin", (H, H))
        out["classifier"] = ("lin", (len(c["id2label"]), H))
    return out


def write_encoder_dir(d: Path, c: dict, seed: int = 0) -> None:
    """config.json, tokenizer.json and model.safetensors of random f32
    weights (N(0, 0.02) from a seeded generator on the card; norms ones and
    zeros) in config c's checkpoint layout."""
    import torch
    from kjarni_tpu_torch.weights.safetensors_loader import save_file
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return (torch.randn(*shape, generator=g, device="cuda") * 0.02).cpu()

    tensors = {}
    for name, (kind, shape) in encoder_modules(c).items():
        if kind == "norm":
            tensors[name + ".weight"] = torch.ones(shape)
            tensors[name + ".bias"] = torch.zeros(shape)
            continue
        tensors[name + ".weight"] = rnd(*shape)
        if kind == "lin":
            tensors[name + ".bias"] = rnd(shape[0])
    d.mkdir(parents=True, exist_ok=True)
    save_file(tensors, d / "model.safetensors")
    (d / "config.json").write_text(json.dumps(c))
    write_bert_tokenizer(d / "tokenizer.json")


def write_bert_tokenizer(path: Path) -> None:
    """A word-level tokenizer.json with BERT's special ids ([PAD] 0, [UNK]
    100, [CLS] 101, [SEP] 102, [MASK] 103), the words w<id> at every other
    id, and BERT's single and pair templates."""
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, processors
    special = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]", 103: "[MASK]"}
    vocab = {special.get(i, f"w{i}"): i for i in range(BERT_VOCAB)}
    tk = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tk.normalizer = normalizers.Lowercase()
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    tk.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
        special_tokens=[("[CLS]", 101), ("[SEP]", 102)])
    tk.save(str(path))


def _sentences(n: int, lo: int, hi: int, seed: int) -> list:
    """n texts of lo..hi random words w<id> (ids 1000..29999, one token each)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(lo, hi + 1, (n,), generator=g).tolist()
    return [" ".join(f"w{i}" for i in torch.randint(1000, 30000, (k,), generator=g).tolist())
            for k in lens]


def _forward_flops(cfg, B: int, S: int) -> float:
    """Multiply-adds x 2 of one encoder forward: projections, FFN, attention."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    per_token = 2 * (4 * H * H + (3 if cfg.swiglu else 2) * H * I) + 4 * S * H
    return float(per_token * B * S * cfg.num_layers)


def run_encoder(name: str, source: str, d: Path, task: str, seed: int) -> dict:
    """One registry encoder through its task API on the card: checks, then
    throughput, device time, profile and memory (one JSON line)."""
    import numpy as np
    import torch
    from kjarni_tpu_torch import Classifier, Embedder, Reranker
    from kjarni_tpu_torch.models import bert as kbert
    from kjarni_tpu_torch.models import encoder_models as em
    from kjarni_tpu_torch.ops.pooling import pool
    # [CLS] + 40..62 words + [SEP], and [CLS] query [SEP] doc [SEP]: seq bucket 64
    texts = _sentences(EMBED_BATCH, 40, EMBED_SEQ - 2, seed)
    query = _sentences(1, 8, 8, seed + 1)[0]
    docs = _sentences(EMBED_BATCH, 30, EMBED_SEQ - 11, seed + 2)
    row = {"model": name, "source": source, "task": task,
           "allocated_before_gb": torch.cuda.memory_allocated() / 1e9}
    t0 = time.perf_counter()
    if task == "embed":
        api = Embedder(str(d))
        model, cls = api._encoder, em.SentenceEncoder

        def call():
            return api.embed_batch(texts)
    elif task == "classify":
        api = Classifier(str(d))
        model, cls = api._clf, em.SequenceClassifier

        def call():
            return api.classify_batch(texts)
    else:
        api = Reranker(str(d))
        model, cls = api._ce, em.CrossEncoder

        def call():
            return api.rerank(query, docs)
    torch.cuda.synchronize()
    row["load_s"] = time.perf_counter() - t0
    check(model.device.type == "cuda"
          and model.params["layers"]["q"]["w"].dtype == torch.bfloat16,
          f"{name}: the task's model runs bf16 on the card")

    # the task's bf16 output against the same model in f32 on the card
    f32 = cls(d, dtype="f32")
    got = call()
    if task == "embed":
        want = f32.encode_batch(texts, pooling=api.pooling, normalize=api.normalize)
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                      * np.linalg.norm(want, axis=-1))
        norm_err = float(np.abs(np.linalg.norm(got, axis=-1) - 1.0).max())
        row.update(min_cosine_bf16_vs_f32=float(cos.min()), max_norm_err=norm_err)
        check(got.shape == (EMBED_BATCH, model.hidden_size) and np.isfinite(got).all(),
              f"{name}: finite embeddings of shape {got.shape}")
        check(cos.min() >= EMBED_COS_MIN,
              f"{name}: bf16 vs f32 cosine {cos.min()} >= {EMBED_COS_MIN}")
        check(norm_err <= 1e-3, f"{name}: |L2 norm - 1| {norm_err} <= 1e-3")
    elif task == "classify":
        labels = api.labels
        probs = np.array([[dict(r.all_scores)[l] for l in labels] for r in got])
        want = f32.classify_scores_batch(texts)
        err = float(np.abs(probs - want).max())
        sum_err = float(np.abs(probs.sum(-1) - 1.0).max())
        row.update(max_prob_err_bf16_vs_f32=err, max_row_sum_err=sum_err,
                   labels_equal=float(np.mean(probs.argmax(-1) == want.argmax(-1))))
        check(probs.shape == (EMBED_BATCH, 2) and np.isfinite(probs).all(),
              f"{name}: finite probabilities of shape {probs.shape}")
        check(err <= CLASSIFY_PROB_ATOL, f"{name}: bf16 vs f32 max |dp| {err} <= "
                                         f"{CLASSIFY_PROB_ATOL}")
        check(sum_err <= 1e-5, f"{name}: rows sum to 1 ({sum_err})")
    else:
        scores = np.empty(len(docs), np.float32)
        for r in got:
            scores[r.index] = r.score
        want = f32.predict_pairs([(query, doc) for doc in docs])
        err = float(np.abs(scores - want).max())
        # pairs whose f32 scores differ by RERANK_ATOL or more keep their order
        gap = want[:, None] - want[None, :]
        flipped = int(((gap >= RERANK_ATOL) & (scores[:, None] <= scores[None, :])).sum())
        row.update(max_score_err_bf16_vs_f32=err, order_flips_beyond_atol=flipped)
        check(len(got) == len(docs) and np.isfinite(scores).all(), f"{name}: scores")
        check(err <= RERANK_ATOL, f"{name}: bf16 vs f32 max |ds| {err} <= {RERANK_ATOL}")
        check(flipped == 0, f"{name}: {flipped} pairs apart by >= {RERANK_ATOL} reordered")

    # f32 on the card against the f32 forward on the CPU, on a few rows
    cpu = cls(d, dtype="f32", device="cpu")
    pairs = [docs[:4]] if task == "rerank" else []
    few = [query] * 4 if task == "rerank" else texts[:4]
    h_card = f32.hidden_states(few, *pairs)[0].cpu().numpy()
    h_cpu = cpu.hidden_states(few, *pairs)[0].numpy()
    row["f32_card_vs_cpu_max_abs_err"] = float(np.abs(h_card - h_cpu).max())
    check(bool(np.allclose(h_card, h_cpu, atol=2e-4, rtol=1e-3)),
          f"{name}: f32 card vs CPU hidden states within atol 2e-4 rtol 1e-3 "
          f"(max {row['f32_card_vs_cpu_max_abs_err']})")
    del f32, cpu
    torch.cuda.empty_cache()

    # end to end, tokenizer included: the median of 5 calls
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(5):
        t = time.perf_counter()
        call()
        runs.append(time.perf_counter() - t)
    row["texts_per_s"] = EMBED_BATCH / statistics.median(runs)
    row["call_ms_runs"] = [1e3 * r for r in runs]
    # the model's weights and the calls' peak, above what was allocated before
    row["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          - row["allocated_before_gb"])

    # a call's tokenization alone (as the model does it), median of 5
    def tokenize():
        if task == "rerank":
            qs = [query] * len(docs)
            ids, mask = model.tokenizer.encode_batch(qs, pairs=docs,
                                                     max_len=model.max_seq_len,
                                                     pad_batch=True)
            return ids, mask, model._pair_type_ids(qs, docs, ids.shape[1], ids.shape[0])
        ids, mask = model.tokenizer.encode_batch(texts, max_len=model.max_seq_len,
                                                 pad_batch=True)
        return ids, mask, np.zeros_like(ids)
    tok_runs = []
    for _ in range(5):
        t = time.perf_counter()
        ids, mask, tt = tokenize()
        tok_runs.append(1e3 * (time.perf_counter() - t))
    row["tokenize_ms"] = statistics.median(tok_runs)
    check(ids.shape == (EMBED_BATCH, EMBED_SEQ), f"{name}: batch {ids.shape} is B256 S64")

    # device time of one B256 S64 forward, from CUDA-graph replays, and the
    # wall time of one eager forward (synchronised; launches from Python)
    ids_d, mask_d, tt_d = model._device_batch(ids, mask, tt)
    p = model.params
    forward = {
        "embed": lambda: pool(api.pooling, model._encode(p, ids_d, mask_d, tt_d), mask_d),
        "classify": lambda: model._logits(p, model.head.params, ids_d, mask_d, tt_d),
        "rerank": lambda: model._score(p, model.head.params, ids_d, mask_d, tt_d),
    }[task]
    with torch.inference_mode():
        row["forward_ms"] = cuda_ms(forward, iters=5)
        row["forward_eager_ms"] = host_ms(forward, iters=5)
    flops = _forward_flops(model.config, EMBED_BATCH, EMBED_SEQ)
    row["forward_tflop_per_s"] = flops / row["forward_ms"] / 1e9
    row["forward_flop_bound_ms"] = bound_ms(0.0, flops)[0]

    if name == "minilm-l6-v2":   # plain against packed rows, for _pack_plan
        pack = {}
        short = _sentences(EMBED_BATCH, 18, 30, seed + 3)
        for S, batch, ns in ((EMBED_SEQ, texts, (1, 2)), (32, short, (1, 2, 4))):
            ids, mask = model.tokenizer.encode_batch(batch, max_len=model.max_seq_len,
                                                     pad_batch=True)
            check(ids.shape == (EMBED_BATCH, S), f"pack batch {ids.shape} is B256 S{S}")
            ids_d, mask_d, tt_d = model._device_batch(ids, mask, np.zeros_like(ids))
            with torch.inference_mode():
                plain = kbert.encode(p, model.config, ids_d, mask_d, tt_d).float()
                for n in ns:
                    def fwd(n=n):
                        if n == 1:
                            return kbert.encode(p, model.config, ids_d, mask_d, tt_d)
                        return kbert.encode_packed_n(p, model.config, ids_d, mask_d, tt_d,
                                                     n=n)
                    if n > 1:
                        out = fwd().float()
                        cos = torch.nn.functional.cosine_similarity(
                            out.reshape(-1), plain.reshape(-1), dim=0).item()
                        check(cos > EMBED_COS_MIN, f"pack-{n} S{S} vs plain cosine {cos}")
                        pack[f"S{S}_n{n}_max_abs_err"] = (out - plain).abs().max().item()
                    pack[f"S{S}_n{n}_ms"] = cuda_ms(fwd, iters=5)
        row["pack"] = pack
        row["pack_plan"] = {f"B{EMBED_BATCH} S{S}": kbert._pack_plan(EMBED_BATCH, S)
                            for S in (EMBED_SEQ, 32)}

    prof = profile_call(call, top=5)
    row.update({k: prof[k] for k in ("profile_wall_ms", "profile_kernel_ms",
                                     "profile_device_busy", "profile_top_kernels",
                                     "profile_top_ops")})
    # the profiler slows the host: the busy share against an unprofiled call
    row["device_busy_share"] = prof["profile_kernel_ms"] / statistics.median(
        row["call_ms_runs"])
    print(json.dumps(row))
    del api, model
    torch.cuda.empty_cache()
    return row


def phase_embed() -> list:
    import torch
    from kjarni_tpu_torch.ops.kernels.flash_attention import flash_attention
    from kjarni_tpu_torch.ops.kernels.int4_matvec import int4_matvec
    counts = flash_attention.launches, int4_matvec.launches
    rows = []
    with tempfile.TemporaryDirectory(prefix="kjarni_embed_") as tmp:
        for i, (name, source, cfg, task) in enumerate(ENCODERS):
            d = Path(tmp) / name
            t0 = time.perf_counter()
            write_encoder_dir(d, cfg, seed=20 + i)
            print(f"{name}: model dir written: {time.perf_counter() - t0:.1f} s, "
                  f"{(d / 'model.safetensors').stat().st_size / 1e9:.2f} GB")
            rows.append(run_encoder(name, source, d, task, seed=30 + 10 * i))
            torch.cuda.empty_cache()
    now = flash_attention.launches, int4_matvec.launches
    check(now == counts, f"the embed phase launched neither hand-written kernel "
                         f"(flash, int4 launches {counts} -> {now})")
    return rows


# ---------------------------------------------------------------------------
# phase 13: search and RAG
# ---------------------------------------------------------------------------

SEARCH_FILES, SEARCH_FILE_CHARS = 1600, 5000
SEARCH_QUERIES = 64
SEARCH_TOP_K = 10
# scores closer than this compare as a set (f32 against f64 differs ~1e-7;
# TF32 inputs move a score ~2e-5)
SEARCH_TIE = 1e-5
STORE_ROWS, STORE_DIM = 1_000_000, 384
SEARCH_FAULTS = ("stale_device_matrix_after_add", "global_ids_not_offset",
                 "tf32_scoring")


def write_corpus(root: Path, n: int, seed: int, chars: int = SEARCH_FILE_CHARS) -> None:
    """n .txt / .md files of `chars` characters: paragraphs of 30-159 random
    words w<id> of the BERT tokenizer (ids 1000..29999), blank lines between."""
    import numpy as np
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        paras, size = [], 0
        while size < chars:
            para = " ".join(f"w{x}" for x in rng.integers(1000, 30000,
                                                            rng.integers(30, 160)).tolist())
            paras.append(para)
            size += len(para) + 2
        (root / f"doc{i:04d}.{'md' if i % 2 else 'txt'}").write_text("\n\n".join(paras)[:chars])


def f64_scores(matrix, query):
    """Exact cosine scores (numpy f64) of every row of `matrix` against
    `query`: the reference a search answer is held to."""
    import numpy as np
    m = np.asarray(matrix, dtype=np.float64)
    q = np.asarray(query, dtype=np.float64)
    norms = np.maximum(np.linalg.norm(m, axis=1), 1e-9)
    return (m @ q) / (norms * max(float(np.linalg.norm(q)), 1e-9))


def topk_agrees(ids, scores, ref, k: int, tol: float = SEARCH_TIE) -> tuple[bool, str]:
    """Whether a top-k answer (ids, scores) is the exact top k of the f64
    reference scores `ref`: the same ids in the same order, where ids whose
    reference scores lie within `tol` of each other compare as a set, and
    each score within `tol` of its reference."""
    import numpy as np
    ids = [int(i) for i in ids]
    if len(ids) != min(k, len(ref)) or len(set(ids)) != len(ids):
        return False, f"{len(ids)} ids for k = {k}"
    got = ref[ids]
    err = float(np.abs(np.asarray(scores, dtype=np.float64) - got).max())
    if err > tol:
        return False, f"a score {err:.3g} off its f64 value"
    kth = np.partition(-ref, len(ids) - 1)[len(ids) - 1] * -1
    if (got < kth - tol).any():
        return False, "an id outside the top k"
    if not set(np.nonzero(ref > kth + tol)[0].tolist()) <= set(ids):
        return False, "a top-k id missing"
    if (np.diff(got) > tol).any():
        return False, "ids out of order"
    return True, ""


@contextlib.contextmanager
def search_fault(name: str):
    """Plant one of SEARCH_FAULTS for the block: the store's device matrix
    kept across add, segment-local ids returned as global ones, or the
    scoring product's inputs rounded to TF32's 10-bit mantissa (what TF32
    tensor cores do)."""
    import torch
    from kjarni_tpu_torch.rag.index import IndexReader
    from kjarni_tpu_torch.search import vector
    saved = []
    if name == "stale_device_matrix_after_add":
        add = vector.VectorStore.add

        def stale(self, embedding):
            keep = self._device_matrix
            i = add(self, embedding)
            self._device_matrix = keep
            return i
        saved.append((vector.VectorStore, "add", add))
        vector.VectorStore.add = stale
    elif name == "global_ids_not_offset":
        saved.append((IndexReader, "_global_id", IndexReader._global_id))
        IndexReader._global_id = lambda self, seg, local: local
    elif name == "tf32_scoring":
        scores = vector._device_scores

        def tf32(x):
            return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
        saved.append((vector, "_device_scores", scores))
        vector._device_scores = lambda m, q: scores(tf32(m), tf32(q))
    else:
        raise ValueError(name)
    try:
        yield
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)


def _search_ok(reader, E, q_embs, queries) -> tuple[bool, str]:
    """The semantic top-k of each query through `reader`, held to the f64
    top-k over the stored embeddings E."""
    for q, qe in zip(queries, q_embs):
        res = reader.search_semantic(qe, SEARCH_TOP_K)
        ok, why = topk_agrees([r.document_id for r in res], [r.score for r in res],
                              f64_scores(E, qe), SEARCH_TOP_K)
        if not ok:
            return False, f"{q[:20]}: {why}"
    return True, ""


def store_at_scale() -> dict:
    """VectorStore over STORE_ROWS x STORE_DIM seeded f32 rows (not
    normalized) on the card: the scoring product's device time beside its
    bound, one search split into device, copy back and host top-k, peak
    memory; top-k against numpy f64, and the TF32 fault must fail it."""
    import numpy as np
    import torch
    from kjarni_tpu_torch.search import vector
    g = torch.Generator(device="cuda").manual_seed(44)
    mat = torch.randn(STORE_ROWS, STORE_DIM, generator=g, device="cuda")
    mat = (mat * (0.5 + torch.rand(STORE_ROWS, 1, generator=g, device="cuda"))).cpu().numpy()
    torch.cuda.empty_cache()
    queries = np.random.default_rng(45).standard_normal((4, STORE_DIM)).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    store = vector.VectorStore(mat)
    t0 = time.perf_counter()
    store.search(queries[0], SEARCH_TOP_K)
    first_s = time.perf_counter() - t0
    dm = store.device_matrix()
    check(dm.is_cuda and dm.dtype == torch.float32 and dm.shape == (STORE_ROWS, STORE_DIM),
          "the store's matrix is f32 on the card")
    qd = torch.from_numpy(queries[0] / np.linalg.norm(queries[0])).cuda()
    device_ms = cuda_ms(lambda: vector._device_scores(dm, qd))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_allowed = store._scores(queries[0])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(np.array_equal(tf32_allowed, store._scores(queries[0])),
          "the store's scores do not move when TF32 is allowed")
    nbytes = 4 * (STORE_ROWS * STORE_DIM + STORE_DIM + STORE_ROWS)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, 2 * STORE_ROWS * STORE_DIM / F32_FLOP_PER_S
    parts = {"device": [], "copy": [], "topk": [], "search": []}
    for i in range(10):
        q = queries[i % 4]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = vector._device_scores(dm, torch.from_numpy(q / np.linalg.norm(q)).cuda())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        h = s.cpu().numpy()
        t2 = time.perf_counter()
        top = np.argpartition(-h, SEARCH_TOP_K - 1)[:SEARCH_TOP_K]
        top = top[np.argsort(-h[top])]
        t3 = time.perf_counter()
        store.search(q, SEARCH_TOP_K)
        t4 = time.perf_counter()
        for k, a, b in (("device", t0, t1), ("copy", t1, t2), ("topk", t2, t3),
                        ("search", t3, t4)):
            parts[k].append(1e3 * (b - a))
    peak_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
    # the f64 reference: norms once, one product per query
    m64 = mat.astype(np.float64)
    norms = np.maximum(np.linalg.norm(m64, axis=1), 1e-9)

    def held(q):
        ref = (m64 @ q.astype(np.float64)) / (norms * np.linalg.norm(q.astype(np.float64)))
        res = store.search(q, SEARCH_TOP_K)
        return topk_agrees([i for i, _ in res], [s for _, s in res], ref, SEARCH_TOP_K)
    for q in queries:
        ok, why = held(q)
        check(ok, f"1M-row store top-{SEARCH_TOP_K} equals numpy f64's: {why}")
    with search_fault("tf32_scoring"):
        faulted = [held(q) for q in queries]
    check(not all(ok for ok, _ in faulted), "the TF32 fault fails the 1M-row f64 check")
    del m64, store, dm
    torch.cuda.empty_cache()
    return {"store_rows": STORE_ROWS, "store_dim": STORE_DIM,
            "store_gb": STORE_ROWS * STORE_DIM * 4 / 1e9,
            "scoring_ms": device_ms, "scoring_bound_ms": 1e3 * max(by_bytes, by_ops),
            "scoring_bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "first_search_s": first_s,
            **{f"search_{k}_ms_p50": statistics.median(v) for k, v in parts.items()},
            "store_peak_gb": peak_gb,
            "tf32_fault": [why for _, why in faulted]}


def phase_search() -> dict:
    """Indexer -> Searcher on the card over a ~12,600-chunk corpus (see the
    module docstring), the 1M-row store and /v1/search; one JSON line."""
    import threading
    import urllib.request
    import numpy as np
    import torch
    from kjarni_tpu_torch import Indexer, Searcher, serve
    from kjarni_tpu_torch.models.encoder_models import CrossEncoder, SentenceEncoder
    from kjarni_tpu_torch.rag.index import IndexReader
    from kjarni_tpu_torch.rag.loader import DocumentLoader
    from kjarni_tpu_torch.search import vector
    from kjarni_tpu_torch.search.hybrid import hybrid_search
    from kjarni_tpu_torch.search.types import SearchMode
    from kjarni_tpu_torch.tasks.searcher import SearchOptions
    counts = _counts()
    row = {"phase": "search"}
    with tempfile.TemporaryDirectory(prefix="kjarni_search_") as tmp:
        tmp = Path(tmp)
        mini, ce = tmp / "minilm-l6-v2", tmp / "minilm-l6-v2-cross-encoder"
        write_encoder_dir(mini, MINILM_L6, seed=40)
        write_encoder_dir(ce, MINILM_CROSS, seed=41)
        docs, idx = tmp / "docs", tmp / "index"
        write_corpus(docs, SEARCH_FILES, seed=42)
        chunks = DocumentLoader().load_paths([docs])

        indexer = Indexer(str(mini), quiet=True)
        check(indexer.embedder._encoder.device.type == "cuda", "the Indexer on the card")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = indexer.create(idx, [docs])
        index_s = time.perf_counter() - t0
        check(stats.chunks == len(chunks) and stats.documents == SEARCH_FILES,
              f"indexed {stats.chunks} chunks of {stats.documents} files; the loader "
              f"reads {len(chunks)} of {SEARCH_FILES}")
        reader = IndexReader.open(idx)
        sizes = [len(s) for s in reader.segments]
        check(sizes[0] == 10_000 and len(sizes) == 2 and
              sizes[1] < vector._DEVICE_MIN_ROWS,
              f"segments {sizes}: one on the device branch and a numpy tail")
        E = np.concatenate([np.asarray(s.embeddings, np.float32) for s in reader.segments])
        pick = np.linspace(0, len(E) - 1, 256).astype(int)
        f32 = SentenceEncoder(mini, dtype="f32").encode_batch(
            [reader.get_document(int(i)) for i in pick])
        cos = (E[pick] * f32).sum(-1) / (np.linalg.norm(E[pick], axis=-1)
                                         * np.linalg.norm(f32, axis=-1))
        check(cos.min() >= EMBED_COS_MIN,
              f"stored embeddings against the f32 encoder: cosine {cos.min()}")
        row.update({"chunks": stats.chunks, "files": stats.documents, "segments": sizes,
                    "index_s": index_s, "chunks_per_s": stats.chunks / index_s,
                    "stored_min_cosine": float(cos.min())})

        queries = _sentences(SEARCH_QUERIES, 8, 16, seed=43)
        searcher = Searcher(str(mini), reranker_model=str(ce), quiet=True)
        cpu = Searcher(str(mini), device="cpu", quiet=True)
        q_embs = [searcher.embedder.embed(q) for q in queries]
        check(all(np.array_equal(searcher.embedder.embed(q), e)
                  for q, e in zip(queries[:4], q_embs)), "the query embedding repeats")
        answers, times = {}, {}
        for mode in ("semantic", "keyword", "hybrid"):
            for rerank in (False, True):
                opts = SearchOptions(mode=SearchMode.parse(mode), top_k=SEARCH_TOP_K,
                                     rerank=rerank)
                res, ms = [], []
                for q in queries:
                    t0 = time.perf_counter()
                    res.append(searcher.search_with_options(idx, q, opts))
                    ms.append(1e3 * (time.perf_counter() - t0))
                answers[mode, rerank] = res
                ms.sort()
                times[mode + ("+rerank" if rerank else "")] = \
                    {"p50_ms": ms[len(ms) // 2], "p95_ms": ms[int(0.95 * len(ms))]}
        row["query_ms"] = times

        ce32 = CrossEncoder(ce, dtype="f32")
        rerank_err = 0.0
        for i, (q, qe) in enumerate(zip(queries, q_embs)):
            ref = f64_scores(E, qe)
            sem = answers["semantic", False][i]
            ok, why = topk_agrees([r.document_id for r in sem], [r.score for r in sem],
                                  ref, SEARCH_TOP_K)
            check(ok, f"semantic top-{SEARCH_TOP_K} equals numpy f64's: {why}")
            kw = answers["keyword", False][i]
            want = cpu.search_with_options(idx, q, SearchOptions(
                mode=SearchMode.KEYWORD, top_k=SEARCH_TOP_K, rerank=False))
            check([(r.document_id, r.score, r.text) for r in kw] ==
                  [(r.document_id, r.score, r.text) for r in want] and kw,
                  "keyword results equal the CPU searcher's")
            kw2 = reader._search_keyword_ids(q, 2 * SEARCH_TOP_K)
            check(kw2 == cpu._reader(idx)._search_keyword_ids(q, 2 * SEARCH_TOP_K),
                  "keyword candidates equal the CPU reader's")
            sem2 = reader._search_semantic_ids(qe, 2 * SEARCH_TOP_K)
            ok, why = topk_agrees([d for d, _ in sem2], [s for _, s in sem2], ref,
                                  2 * SEARCH_TOP_K)
            check(ok, f"semantic candidates equal numpy f64's: {why}")
            hyb = answers["hybrid", False][i]
            check([r.document_id for r in hyb] ==
                  [d for d, _ in hybrid_search(kw2, sem2, SEARCH_TOP_K)],
                  "hybrid ids are the RRF of the checked lists")
            for (mode, rerank), res in answers.items():
                check(all(r.text == reader.get_document(r.document_id) for r in res[i]),
                      f"{mode} result texts are their documents")
                if rerank and res[i]:
                    got = np.array([r.score for r in res[i]])
                    want = ce32.predict_pairs([(q, r.text) for r in res[i]])
                    rerank_err = max(rerank_err, float(np.abs(got - want).max()))
                    check((np.diff(got) <= 0).all(), "reranked scores descend")
        check(rerank_err <= RERANK_ATOL, f"rerank scores within {RERANK_ATOL} of the f32 "
                                         f"cross-encoder: {rerank_err}")
        row["rerank_max_abs_err"] = rerank_err

        # planted faults: each must fail its check
        faults = {}
        seg = vector.VectorStore(np.asarray(reader.segments[0].embeddings, np.float32))
        for name in ("stale_device_matrix_after_add", None):
            with search_fault(name) if name else contextlib.nullcontext():
                s = vector.VectorStore(seg.matrix.copy())
                s.search(q_embs[0], 1)
                new = s.add(q_embs[0] * 3.0)
                found = s.search(q_embs[0], 1)[0][0] == new
            check(found == (name is None), f"a row added after a search is found "
                                           f"({name or 'sound'}: {found})")
        faults["stale_device_matrix_after_add"] = "row not found"
        for name in ("global_ids_not_offset", "tf32_scoring"):
            with search_fault(name):
                ok, why = _search_ok(reader, E, q_embs[:8], queries[:8])
            check(not ok, f"the {name} fault fails the f64 check")
            faults[name] = why
        row["faults"] = faults

        # /v1/search through serve.py's server
        engine = serve._Engine({"search": str(mini)})
        srv = serve.KjarniHTTPServer(("127.0.0.1", 0), serve.make_handler(engine))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        http_ms = []
        try:
            for i in (0, 1):   # the first request loads the server's Searcher
                body = {"index": str(idx), "query": queries[i], "mode": "hybrid",
                        "top_k": SEARCH_TOP_K}
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.server_port}/v1/search",
                    data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"})
                t0 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=300) as r:
                    code, out = r.status, json.loads(r.read())
                http_ms.append(1e3 * (time.perf_counter() - t0))
                want = answers["hybrid", False][i]
                check(code == 200 and [(x["text"], x["metadata"]) for x in out["results"]]
                      == [(r.text, r.metadata) for r in want] and
                      max(abs(x["score"] - r.score) for x, r in zip(out["results"], want))
                      <= 1e-6, "/v1/search answers as the Searcher")
        finally:
            srv.shutdown()
            srv.server_close()
        row["http_search_ms"] = {"first (loads the Searcher)": http_ms[0],
                                 "second": http_ms[1]}
        del searcher, cpu, ce32, engine
        gc.collect()
        torch.cuda.empty_cache()
    row.update(store_at_scale())
    check(_counts() == counts, f"the search phase launched neither hand-written kernel "
                               f"(flash, int4 launches {counts} -> {_counts()})")
    print(json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# phase 14: execution plans, the native checkpoint, profiling
# ---------------------------------------------------------------------------

INFRA_NEW_TOKENS = 32
# the offload plan's first prefill logits against the device plan's: the
# embedding rows are the same bf16 values and the host head rounds once to
# bf16, so a sound run reads ~1 bf16 ulp of the largest logit; the fed-in
# pre-norm state scales every logit by the residual stream's rms
INFRA_COS_MIN, INFRA_REL_MAX = 0.999, 0.02
INFRA_FAULTS = ("head_fed_pre_norm", "embed_ids_shifted")


@contextlib.contextmanager
def infra_fault(name: str, lm):
    """Plant one of INFRA_FAULTS in the llama forward for the block: the
    final norm skipped before the (offloaded) head, or the host gather
    reading the ids shifted by one."""
    from kjarni_tpu_torch.models import llama as kllama
    attr = {"head_fed_pre_norm": "rms_norm", "embed_ids_shifted": "host_gather"}[name]
    orig = getattr(kllama, attr)
    if name == "head_fed_pre_norm":
        final = lm.params["final_norm"]
        kllama.rms_norm = lambda x, w, eps: x if w is final else orig(x, w, eps)
    else:
        kllama.host_gather = lambda t, ids: orig(t, (ids + 1) % t.shape[0])
    try:
        yield
    finally:
        setattr(kllama, attr, orig)


def _plan_logits(got, ref) -> dict:
    return {"cosine": _cosine(got, ref),
            "rel_err": (got - ref).abs().max().item() / ref.abs().max().item()}


def _plan_ok(st: dict) -> bool:
    return st["cosine"] >= INFRA_COS_MIN and st["rel_err"] <= INFRA_REL_MAX


def _plan_request(gen, text: str, tag: str, flash_want: int | None,
                  int4: bool = False) -> dict:
    """One greedy generate of INFRA_NEW_TOKENS, its launches checked (int4:
    int4_per_forward per forward); returns the prompt and generated ids and
    the seconds."""
    import torch
    from kjarni_tpu_torch.generate.sampling import GenerationConfig
    lm = gen.lm
    ids = lm.encode_prompt(text)
    f0, i0 = _counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen.generate(text, config=GenerationConfig.greedy(max_new_tokens=INFRA_NEW_TOKENS,
                                                      max_length=4096))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out = lm._session_ids[len(ids):]
    flash_n, int4_n = _counts()[0] - f0, _counts()[1] - i0
    if flash_want is not None:
        check(flash_n == flash_want, f"{tag}: {flash_n} flash launches, expected {flash_want}")
    per = int4_per_forward(lm.config.num_layers) if int4 else 0
    check(int4_n == per * (1 + len(out)),
          f"{tag}: {int4_n} int4 launches, expected {per} per forward")
    check(len(out) > 0, f"{tag}: generated tokens")
    return {"ids": ids, "out": out, "seconds": secs, "flash": flash_n, "int4": int4_n}


def _tie_band(ref_lm, req: dict) -> float:
    """The largest margin of a request's greedy tokens in a teacher-forced
    single-stream forward of the reference model (plain kernels)."""
    ids, out = req["ids"], req["out"]
    ref = _teacher_forced(ref_lm, ids + out[:-1],
                          list(range(len(ids) - 1, len(ids) - 1 + len(out))))
    return max(_margins(ref, out))


def _stream_rate(gen, text: str) -> dict:
    """Time to first token and decode tok/s of a 32-token greedy stream."""
    import torch
    from kjarni_tpu_torch.generate.sampling import GenerationConfig
    cfg = GenerationConfig.greedy(max_new_tokens=32, max_length=4096)
    n, first = 0, None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in gen.generate_stream(text, config=cfg):
        if n == 0:
            torch.cuda.synchronize()
            first = time.perf_counter()
        n += 1
    torch.cuda.synchronize()
    return {"ttft_ms": 1e3 * (first - t0), "tok_per_s": (n - 1) / (time.perf_counter() - first)}


def _prefill_ms(lm, ids) -> float:
    """Median of 3 synchronised first prefills (their launches restored)."""
    import torch
    counts, runs = _counts(), []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill_logits(lm, ids)
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0))
    _restore(counts)
    return statistics.median(runs)


def _loaded(fn):
    """(object, seconds, device bytes it holds) of one synchronised load."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    obj = fn()
    torch.cuda.synchronize()
    return obj, time.perf_counter() - t0, torch.cuda.memory_allocated() - before


def _same_tree(a, b) -> bool:
    import torch
    if isinstance(a, dict) or isinstance(b, dict):
        return isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys() and \
            all(_same_tree(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and a.device == b.device and \
        bool(torch.equal(a, b))


def phase_infra(d: Path, tmp: Path) -> dict:
    """Execution plans, the native checkpoint and profiling over the phase-3
    Llama-3.2-1B-width weights (see the module docstring); one JSON line."""
    import torch
    from kjarni_tpu_torch import Generator
    from kjarni_tpu_torch.core import placement, profiling
    from kjarni_tpu_torch.generate.sampling import GenerationConfig
    from kjarni_tpu_torch.models.decoder_lm import DecoderLM
    from kjarni_tpu_torch.weights.checkpoint import convert_model
    text, text2 = _prompt(700, 1), _prompt(600, 2)
    table_bytes = LLAMA_1B["vocab_size"] * LLAMA_1B["hidden_size"] * 2
    row = {"phase": "infra"}

    # offload_ends in bf16 against the device plan
    dev, dev_s, dev_bytes = _loaded(lambda: Generator(str(d)))
    off, off_s, off_bytes = _loaded(lambda: Generator(str(d), execution_plan="offload_ends"))
    p = off.lm.params
    check(off.lm.config.embed_on_host and off.lm.config.lm_head_on_host and
          p["embed"].device.type == "cpu" and p["embed"].is_pinned() and
          p["lm_head"].untyped_storage().data_ptr() == p["embed"].untyped_storage().data_ptr(),
          "offload_ends: the table in pinned host memory once, the tied head a view of it")
    check(dev_bytes - off_bytes >= table_bytes,
          f"offload_ends holds {dev_bytes - off_bytes} fewer device bytes than the device "
          f"plan, at least the table's {table_bytes}")
    ids = dev.lm.encode_prompt(text)
    counts = _counts()
    ref = prefill_logits(dev.lm, ids)
    got = prefill_logits(off.lm, ids)
    st = _plan_logits(got, ref)
    check(_plan_ok(st), f"offload_ends first prefill logits against the device plan: {st}")
    faults = {}
    for name in INFRA_FAULTS:
        with infra_fault(name, off.lm):
            bad = _plan_logits(prefill_logits(off.lm, ids), ref)
        check(not _plan_ok(bad), f"the {name} fault fails the logits check: {bad}")
        faults[name] = bad
    _restore(counts)
    req = _plan_request(off, text, "offload_ends", off.lm.config.num_layers)
    margin = _tie_band(dev.lm, req)
    check(margin <= SERVE_TIE_BAND, f"offload_ends greedy tokens within the tie band "
                                    f"of the device plan: {margin}")
    dev_req = _plan_request(dev, text, "device plan", dev.lm.config.num_layers)
    x = torch.randn(1, LLAMA_1B["hidden_size"], dtype=torch.bfloat16, device="cuda")
    tok = torch.tensor([[12345]], device="cuda")
    row["bf16"] = {
        "load_s": {"device": dev_s, "offload_ends": off_s},
        "device_gb": {"device": dev_bytes / 1e9, "offload_ends": off_bytes / 1e9},
        "logits": st, "faults": faults, "tie_band_max_margin": margin,
        "generate_s": {"device": dev_req["seconds"], "offload_ends": req["seconds"]},
        "prefill_ms": {"device": _prefill_ms(dev.lm, ids), "offload_ends": _prefill_ms(off.lm, ids)},
        "stream": {"device": _stream_rate(dev, text2), "offload_ends": _stream_rate(off, text2)},
        "head_ms_per_token": {"host": host_ms(lambda: placement.host_matmul(x, p["lm_head"])),
                              "device": cuda_ms(lambda: x @ dev.lm.params["lm_head"])},
        "gather_ms_per_token": {"host": host_ms(lambda: placement.host_gather(p["embed"], tok)),
                                "device": cuda_ms(lambda: torch.nn.functional.embedding(
                                    tok, dev.lm.params["embed"]))},
    }
    del dev, off, p, got, ref
    gc.collect()
    torch.cuda.empty_cache()

    # int4 under offload_embeddings and offload_head, and the native checkpoint
    dev4, dev4_s, _ = _loaded(lambda: Generator(str(d), quantize="int4"))
    emb4 = Generator(str(d), quantize="int4", execution_plan="offload_embeddings")
    check(emb4.lm.config.embed_on_host and not emb4.lm.config.lm_head_on_host,
          "offload_embeddings in int4: the table on the host, the head on the card")
    req4 = _plan_request(emb4, text, "int4 offload_embeddings", emb4.lm.config.num_layers,
                         int4=True)
    margin4 = _tie_band(dev4.lm, req4)
    check(margin4 <= SERVE_TIE_BAND, f"int4 offload_embeddings tokens within the tie "
                                     f"band of the device plan: {margin4}")
    del emb4
    head4 = Generator(str(d), quantize="int4", execution_plan="offload_head")
    h = head4.lm.params["lm_head"]
    check(not head4.lm.config.lm_head_on_host and isinstance(h, dict) and h["w4"].is_cuda
          and head4.lm.params["embed"].is_cuda,
          "offload_head in int4: the quantized head stays on the card")
    del head4, h
    gc.collect()
    torch.cuda.empty_cache()
    ck = tmp / "llama-3.2-1b-int4-ckpt"
    t0 = time.perf_counter()
    convert_model(d, ck, quantize="int4")
    convert_s = time.perf_counter() - t0
    lm_ck, ck_s, _ = _loaded(lambda: DecoderLM(ck))
    check(_same_tree(lm_ck.params, dev4.lm.params),
          "the int4 checkpoint loads params bit-equal to the in-memory quantized tree")
    cfg = GenerationConfig.greedy(max_new_tokens=INFRA_NEW_TOKENS, max_length=4096)
    lm_ck.generate(text, config=cfg)
    dev4.lm.generate(text, config=cfg)
    check(lm_ck._session_ids == dev4.lm._session_ids,
          "the checkpoint's greedy ids equal the safetensors load's")
    row["int4"] = {"tie_band_max_margin": margin4, "int4_launches": req4["int4"],
                   "flash_launches": req4["flash"], "generate_s": req4["seconds"],
                   "load_s": {"safetensors": dev4_s, "checkpoint": ck_s},
                   "convert_s": convert_s,
                   "checkpoint_gb": sum(f.stat().st_size for f in ck.rglob("*")) / 1e9}

    # profiling around one request
    with profiling.trace(tmp / "trace") as prof:
        with profiling.annotate("kjarni-request"):
            lm_ck.generate(_prompt(300, 5), config=GenerationConfig.greedy(
                max_new_tokens=8, max_length=4096))
    events = json.loads((tmp / "trace" / profiling.TRACE_FILE).read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    check(any(e.get("name") == "kjarni-request" for e in events) and kernels,
          "the trace holds the annotated span and the card's kernels")
    report = profiling.device_memory_report()
    check(torch.cuda.get_device_name(0) in report[0]["device"] and
          0 < report[0]["live_buffer_mb"] <= report[0]["peak_mb"],
          f"the memory report names the card with live and peak MB: {report[0]}")
    row["profile"] = {"events": len(events), "kernels": len(kernels),
                      "kernel_ms": sum(e.get("dur", 0) for e in kernels) / 1e3,
                      "ops": len(prof.key_averages()), "memory": report[0]}
    del lm_ck, dev4
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps(row))
    return row



# ---------------------------------------------------------------------------
# phase 15: f32 on the card
# ---------------------------------------------------------------------------

F32_NEW_TOKENS = 32
F32_TIE = 1e-4          # a card / CPU greedy parting is allowed only below this top-2 gap
# the first prefill's f32 logits (no int4) against the plain versions: only
# the order of the sums differs (f32 flash, cuBLAS), as a share of the
# largest logit
F32_LOGITS_REL = 1e-4


# bf16 int4 launches held one by one on their own input: the card tests'
# int4 check against the plain version evaluated in f32
INT4_BF16_REL, INT4_BF16_COS = 2e-2, 0.999


def _int4_teacher_forced(lm, ids: list, tag: str) -> dict:
    """Each int4 launch of a full-depth prefill, held on its own input.

    bf16: against int4_matvec_plain evaluated in f32, max error within
    INT4_BF16_REL of the largest plain output and cosine above
    INT4_BF16_COS.

    f32: and the cause of the forward's end-to-end drift. The plain forward
    in the kernels' form (plain_kernels(x_as_bf16=True)) first keeps every
    int4 input rounded to bf16. The kernels' forward then holds each int4
    launch, on the x it was given, to the plain version in that form with
    _int4_f32_close (INT4_F32_REF_TOL, and the bf16-store control outside
    it), and counts the elements whose bf16 rounding differs from the plain
    forward's at the same call: none at the first call (the same embedding
    and norm), then more with depth, as the f32 sums' order differs
    upstream."""
    import torch
    from kjarni_tpu_torch.models import llama as kllama
    from kjarni_tpu_torch.ops.kernels import int4_matvec as i4
    kernel = kllama.int4_matvec
    f32 = lm._cache_dtype == torch.float32
    kept, calls = [], []

    def keep(x, w4, scale):
        kept.append(x.to(torch.bfloat16))
        return i4.int4_matvec_plain(x, w4, scale, x_as_bf16=True)

    def held(x, w4, scale):
        out = kernel(x, w4, scale)
        i = len(calls)
        if not f32:
            ref = i4.int4_matvec_plain(x.float(), w4, scale)
            calls.append({"rel": (out.float() - ref).abs().max().item()
                          / ref.abs().max().item(), "cos": _cosine(out, ref)})
            return out
        ref = i4.int4_matvec_plain(x, w4, scale, x_as_bf16=True)
        row = _int4_f32_close(f"{tag} teacher-forced int4 call {i}", out, ref)
        xb = x.to(torch.bfloat16)
        row["flips"] = int((xb != kept[i]).sum().item()) if i < len(kept) and \
            kept[i].shape == xb.shape else None
        row["elements"] = xb.numel()
        calls.append(row)
        return out

    if f32:
        with plain_kernels(x_as_bf16=True):
            kllama.int4_matvec = keep
            prefill_logits(lm, ids)
    counts = _all_counts()
    kllama.int4_matvec = held
    try:
        prefill_logits(lm, ids)
    finally:
        kllama.int4_matvec = kernel
        _restore(counts)
    L = lm.config.num_layers
    want = int4_per_forward(L)
    check(len(calls) == want and (not f32 or len(kept) == want),
          f"{tag} teacher-forced: {len(calls)} int4 calls, {len(kept)} kept, expected {want}")
    if not f32:
        rel, cos = max(c["rel"] for c in calls), min(c["cos"] for c in calls)
        check(rel <= INT4_BF16_REL and cos > INT4_BF16_COS,
              f"{tag} teacher-forced: every int4 launch within {INT4_BF16_REL} of the plain "
              f"output's largest value ({rel}) at cosine > {INT4_BF16_COS} ({cos})")
        out = {"teacher_forced_calls": len(calls), "int4_max_err_share": [rel, INT4_BF16_REL],
               "int4_min_cosine": [cos, INT4_BF16_COS]}
        print(json.dumps({"case": f"{tag} teacher-forced", **out}))
        return out
    check(calls[0]["flips"] == 0, f"{tag} teacher-forced: the first int4 input rounds "
                                  f"alike in both forwards ({calls[0]['flips']} flips)")
    flips = [sum(c["flips"] for c in calls[i:i + 7]) / sum(c["elements"]
                                                            for c in calls[i:i + 7])
             for i in range(0, 7 * L, 7)]
    out = {"teacher_forced_calls": len(calls),
           "teacher_forced_err_over_tol": max(c["max_abs_err"] / c["tol"] for c in calls),
           "teacher_forced_control_over_tol": min(c["bf16_store_control_err"] / c["tol"]
                                                  for c in calls),
           "x_bf16_flip_share_by_layer": flips}
    print(json.dumps({"case": f"{tag} teacher-forced", **out}))
    del kept
    return out


def _f32_logits_vs_plain(lm, text: str, tag: str) -> dict:
    """The first prefill's f32 logits through the kernels against the same
    forward on the plain versions, and prefill ms as the median of 5.

    Without int4 both are f32 throughout and differ only in the order of
    their sums: within F32_LOGITS_REL of the largest logit. Under int4 the
    kernel rounds each x to bf16, as the Pallas kernel does, so an element
    whose f32 value differs in its last bits from the plain forward's can
    round to another bf16 value; 16 layers of random weights carry such
    flips forward. _int4_teacher_forced holds every int4 launch on its own
    input (the tight bound) and counts the flips per layer (the cause). The
    logits then are held as the bf16 path is: no further from the plain f32
    forward (x not rounded) than twice the plain forward in the kernels'
    form (x rounded to bf16) is."""
    import torch
    ids = lm.encode_prompt(text)
    counts = _all_counts()
    got = prefill_logits(lm, ids)
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill_logits(lm, ids)
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0))
    _restore(counts)
    with plain_kernels(x_as_bf16=True):
        ref = prefill_logits(lm, ids)
    with plain_kernels():
        ref32 = prefill_logits(lm, ids)
    err = (got - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    out = {"logits_max_abs_err": err, "logits_rel_err": rel,
           "logits_cosine": _cosine(got, ref),
           "prefill_ms_1024": statistics.median(runs), "prefill_ms_1024_runs": runs}
    check(bool(torch.isfinite(got).all()) and got.shape == (1, lm.config.vocab_size),
          f"{tag}: finite logits of shape {tuple(got.shape)}")
    if "int4" not in tag:
        check(rel <= F32_LOGITS_REL, f"{tag} prefill logits vs plain: {rel} of the "
                                     f"largest logit <= {F32_LOGITS_REL}")
        return out
    out.update(_int4_teacher_forced(lm, ids, tag))
    out["kernels_vs_f32_max_abs_err"] = (got - ref32).abs().max().item()
    out["plain_x_bf16_vs_f32_max_abs_err"] = (ref - ref32).abs().max().item()
    check(out["kernels_vs_f32_max_abs_err"] <= 2 * out["plain_x_bf16_vs_f32_max_abs_err"],
          f"{tag} prefill logits vs f32: kernels {out['kernels_vs_f32_max_abs_err']} <= "
          f"2 x plain with x in bf16 {out['plain_x_bf16_vs_f32_max_abs_err']}")
    return out


def f32_request(d: Path, quantize) -> dict:
    """Generator(dtype="f32") at full width: the first prefill's logits
    against the plain versions, the phase-3 request (701-token prompt, 32 new
    tokens) with 16 f32 flash launches per prefill and no bf16 flash launch
    (113 int4 per forward under int4), then a 32-token stream: time to first
    token, decode tok/s, peak memory."""
    import torch
    from kjarni_tpu_torch import Generator
    from kjarni_tpu_torch.generate.sampling import GenerationConfig
    from kjarni_tpu_torch.ops.kernels.flash_attention import flash_attention
    from kjarni_tpu_torch.ops.kernels.int4_matvec import int4_matvec
    tag = "f32" + (f" {quantize}" if quantize else "")
    t0 = time.perf_counter()
    gen = Generator(str(d), dtype="f32", quantize=quantize)
    lm = gen.lm
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(lm.device.type == "cuda" and lm._cache_dtype == torch.float32
          and lm.params["embed"].dtype == torch.float32, f"{tag}: f32 on the card")
    stats = _f32_logits_vs_plain(lm, _prompt(700, 1), tag)
    torch.cuda.reset_peak_memory_stats()
    cfg = GenerationConfig.greedy(max_new_tokens=F32_NEW_TOKENS, max_length=4096)
    rows = {}
    for name, text in (("generate 700", _prompt(700, 1)), ("stream 600", _prompt(600, 2))):
        before = flash_attention.launches, flash_attention.launches_f32, int4_matvec.launches
        n_prompt = len(lm.encode_prompt(text))
        torch.cuda.synchronize()
        t = time.perf_counter()
        first = None
        if name.startswith("stream"):
            for _ in gen.generate_stream(text, config=cfg):
                if first is None:
                    torch.cuda.synchronize()
                    first = time.perf_counter()
        else:
            gen.generate(text, config=cfg)
        torch.cuda.synchronize()
        end = time.perf_counter()
        n_new = len(lm._session_ids) - n_prompt
        got = (flash_attention.launches - before[0], flash_attention.launches_f32 - before[1],
               int4_matvec.launches - before[2])
        L = lm.config.num_layers
        want_int4 = int4_per_forward(L) * (1 + n_new) if quantize == "int4" else 0
        check(n_new > 0 and got == (0, L, want_int4),
              f"{tag} {name}: launches (bf16 flash, f32 flash, int4) {got}, expected "
              f"(0, {L}, {want_int4})")
        row = {"request": f"{tag} {name}", "prompt_tokens": n_prompt, "new_tokens": n_new,
               "seconds": end - t, "flash_f32_launches": got[1], "int4_launches": got[2]}
        if first is not None:
            row["ttft_ms"] = 1e3 * (first - t)
            row["decode_tok_per_s"] = (n_new - 1) / (end - first)
        rows[name] = row
        print(json.dumps(row))
    summary = {"slice": tag, "load_s": load_s, **stats,
               "stream_ttft_ms": rows["stream 600"]["ttft_ms"],
               "stream_decode_tok_per_s": rows["stream 600"]["decode_tok_per_s"],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps(summary))
    del gen, lm
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def f32_ids_vs_cpu(d: Path, tmp: Path, text: str) -> dict:
    """The first 2 layers of the phase-3 weights (write_model_dir's seeded
    order gives a 2-layer dir the 16-layer dir's table and first two layers)
    in f32 on the card and on the CPU: 32 greedy ids, equal, or parting only
    where the CPU's top-2 logits lie within F32_TIE (the gap is reported)."""
    import torch
    from kjarni_tpu_torch import Generator
    from kjarni_tpu_torch.generate.sampling import GenerationConfig
    d2 = tmp / "llama-3.2-1b-2-layers"
    write_model_dir(d2, c={**LLAMA_1B, "num_hidden_layers": 2})
    write_tokenizer(d2 / "tokenizer.json", LLAMA_1B["vocab_size"])
    from kjarni_tpu_torch.weights.safetensors_loader import ModelWeights
    for name in ("model.embed_tokens.weight", "model.layers.1.mlp.down_proj.weight"):
        check(torch.equal(ModelWeights(d2).get(name), ModelWeights(d).get(name)),
              f"the 2-layer dir holds the phase-3 dir's {name}")
    cfg = GenerationConfig.greedy(max_new_tokens=F32_NEW_TOKENS, max_length=4096)
    out = {}
    for where in ("cuda", "cpu"):
        gen = Generator(str(d2), dtype="f32", device=where)
        ids = gen.lm.encode_prompt(text)
        gen.generate(text, config=cfg)
        out[where] = gen.lm._session_ids[len(ids):]
        if where == "cpu":
            cpu_lm, prompt_ids = gen.lm, ids
        del gen
    torch.cuda.empty_cache()
    n = _common_prefix(out["cuda"], out["cpu"])
    row = {"case": "f32 greedy ids, 2 layers, card vs CPU", "tokens": len(out["cpu"]),
           "equal_prefix": n}
    if n < min(len(out["cuda"]), len(out["cpu"])):
        logits = prefill_logits(cpu_lm, prompt_ids + out["cpu"][:n], device="cpu")[0]
        top2 = torch.topk(logits, 2).values
        row["parting_step"] = n
        row["cpu_top2_gap"] = (top2[0] - top2[1]).item()
        check(row["cpu_top2_gap"] < F32_TIE, f"f32 card ids part from the CPU's at step "
                                             f"{n} with a top-2 gap {row['cpu_top2_gap']}")
    else:
        check(out["cuda"] == out["cpu"], "f32 card ids equal the CPU's")
    del cpu_lm
    gc.collect()
    print(json.dumps(row))
    return row


def phase_f32(d: Path, tmp: Path, ran: dict) -> dict:
    """Phase 15: Generator(dtype="f32") on the card, plain weights and int4,
    beside phase 3's bf16 numbers; then 2-layer greedy ids against the CPU."""
    rows = {q or "f32": f32_request(d, q) for q in (None, "int4")}
    ids = f32_ids_vs_cpu(d, tmp, _prompt(700, 1))
    bf16 = ran.get("bf16") or {}
    line = {"case": "f32 on the card", **{
        f"{k}_{key}": rows[k][key] for k in rows
        for key in ("prefill_ms_1024", "stream_ttft_ms", "stream_decode_tok_per_s",
                    "peak_mem_gb", "logits_rel_err", "load_s")},
        **{f"bf16_{key}": bf16.get(key) for key in ("prefill_ms_1024", "stream_ttft_ms",
                                                     "stream_decode_tok_per_s",
                                                     "peak_mem_gb")},
        "ids_equal_prefix": ids["equal_prefix"], "ids_tokens": ids["tokens"],
        "ids_cpu_top2_gap": ids.get("cpu_top2_gap")}
    print(json.dumps(line))
    return line


# ---------------------------------------------------------------------------
# phase 16: the user surfaces (CLI, C ABI)
# ---------------------------------------------------------------------------

SURFACE_NEW_TOKENS = 32
SURFACE_LAYERS = 4          # the generator's depth here: full width, cut depth
SURFACE_EMBED_TOL = 1e-6
TINY_LLAMA = {"model_type": "llama", "vocab_size": 4096, "hidden_size": 256,
              "intermediate_size": 512, "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 64, "max_position_embeddings": 2048,
              "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
              "bos_token_id": 1, "eos_token_id": 2, "torch_dtype": "bfloat16"}


def _python_env() -> dict:
    """The environment of a process that embeds CPython through
    libkjarni.so: that interpreter knows nothing of this one's site-packages
    or the checkout, so both come in through PYTHONPATH."""
    import os
    import site
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + site.getsitepackages()
                                        + [env.get("PYTHONPATH", "")])
    return env


def _ctypes_lib(path: Path):
    import ctypes
    L = ctypes.CDLL(str(path))
    L.kjarni_init.restype = ctypes.c_int
    L.kjarni_last_error.restype = ctypes.c_char_p
    L.kjarni_new.restype = ctypes.c_longlong
    L.kjarni_new.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    L.kjarni_call.restype = ctypes.c_void_p
    L.kjarni_call.argtypes = [ctypes.c_longlong, ctypes.c_char_p, ctypes.c_char_p]
    L.kjarni_string_free.argtypes = [ctypes.c_void_p]
    L.kjarni_free.argtypes = [ctypes.c_longlong]
    L.kjarni_stream_start.restype = ctypes.c_int
    L.kjarni_stream_start.argtypes = [ctypes.c_longlong, ctypes.c_char_p, ctypes.c_char_p]
    L.kjarni_stream_next.restype = ctypes.c_void_p
    L.kjarni_stream_next.argtypes = [ctypes.c_longlong]
    return L


def phase_surfaces(d: Path, tmp: Path) -> dict:
    """Phase 16: the port's CLI in this process in a cwd whose kjarni.toml
    sets quantize = "int4" for the phase-3 dir: generate --format json on the
    701-token prompt (flash and int4 launch; its text equals Generator's with
    the same options, and is empty: the CLI has no --max-length, and the
    default max_length of 100 counts the prompt, in the JAX CLI too), and on
    a 60-token prompt that generates 32 tokens (int4 launches, the text
    equals Generator's); `python -m kjarni_tpu_torch embed` as a
    subprocess on a MiniLM dir (its vector within 1e-6 of the in-process
    Embedder's); the port's libkjarni.so built from the checkout and driven
    through ctypes in this process (one kjarni_call and then one pull stream
    of a generator with quantize int4 on the 701-token prompt, with
    max_length 4096 in the args: both kernels launch, texts equal a
    Generator's making the same two calls); the
    port's compiled C host as a subprocess against MiniLM,
    DistilBERT-SST-2 and a small llama dir on the card. The generator runs
    at full width over the first SURFACE_LAYERS layers of the phase-3
    weights. Seconds per step, and each surface's beyond the Python API's
    (overhead_s)."""
    import contextlib as cl
    import ctypes
    import io
    import os
    import numpy as np
    import torch
    from kjarni_tpu_torch import Embedder, Generator
    from kjarni_tpu_torch.cli.main import main as cli_main
    from kjarni_tpu_torch.ffi import build as ffi_build
    from kjarni_tpu_torch.tasks.generator import resolve_generation_config
    secs, row = {"write_dirs": 0.0}, {"case": "surfaces", "layers": SURFACE_LAYERS}
    d = layers_view(d, tmp / f"llama-3.2-1b-{SURFACE_LAYERS}-layers-surfaces", SURFACE_LAYERS)
    text, short = _prompt(700, 1), _prompt(59, 9)
    cli_cfg = resolve_generation_config("greedy", None, max_new_tokens=SURFACE_NEW_TOKENS)
    abi_cfg = dataclasses.replace(cli_cfg, max_length=4096)

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t0
        return out

    # the Python API, step by step: the reference texts and the yardstick of
    # the CLI and the ABI. The ABI's handle runs generate, then a stream of the
    # same prompt over the cache the generate left (prefix reuse): the
    # reference does the same. The first pass warms what a first call pays
    # (the page cache, allocator, cuBLAS); the second is timed
    for rep in range(2):
        tag = "api" if rep else "warm"
        ref = timed(f"{tag}_load", lambda: Generator(str(d), quantize="int4"))
        got = {"cli_700": timed(f"{tag}_cli_700", lambda: ref.generate(text, config=cli_cfg)),
               "cli_60": timed(f"{tag}_cli_60", lambda: ref.generate(short, config=cli_cfg)),
               "abi_700": timed(f"{tag}_abi_700", lambda: ref.generate(text, config=abi_cfg)),
               "abi_stream": timed(f"{tag}_abi_stream", lambda: "".join(
                   st.text for st in ref.generate_stream(text, config=abi_cfg)))}
        check(not rep or got == want, "the Python API repeats its texts")
        want = got
        del ref
    check(want["cli_700"] == "" and want["cli_60"] and want["abi_700"] and want["abi_stream"],
          "the reference texts: empty under max_length 100, else generated")
    gc.collect()
    torch.cuda.empty_cache()

    # the CLI, in this process, under a kjarni.toml
    cwd = tmp / "cli_cwd"
    cwd.mkdir()
    (cwd / "kjarni.toml").write_text(f'[models."{d}"]\nquantize = "int4"\n')
    old = os.getcwd()
    for key, prompt, flash_want in (("cli_700", text, SURFACE_LAYERS), ("cli_60", short, 0)):
        before = _counts()
        buf = io.StringIO()
        try:
            os.chdir(cwd)
            with cl.redirect_stdout(buf):
                rc = timed(key, lambda: cli_main(
                    ["generate", prompt, "--model", str(d), "--max-tokens",
                     str(SURFACE_NEW_TOKENS), "--preset", "greedy", "--format", "json"]))
        finally:
            os.chdir(old)
        got = [a - b for a, b in zip(_counts(), before)]
        check(rc == 0, f"CLI generate ({key}) exited {rc}")
        cli_text = json.loads(buf.getvalue())["text"]
        check(got[0] == flash_want and got[1] > 0, f"CLI generate ({key}) launched flash "
                                                   f"{got[0]} (want {flash_want}), int4 {got[1]}")
        check(cli_text == want[key], f"CLI generate's text ({key}) equals Generator's")
        row.update({f"{key}_flash_launches": got[0], f"{key}_int4_launches": got[1],
                    f"{key}_chars": len(cli_text)})
        gc.collect()
        torch.cuda.empty_cache()

    # python -m kjarni_tpu_torch embed, a real subprocess on the card
    mini = tmp / "minilm-l6-v2"
    t0 = time.perf_counter()
    write_encoder_dir(mini, MINILM_L6, seed=20)
    secs["write_dirs"] += time.perf_counter() - t0
    sentence = "the quick brown fox jumps over the lazy dog near the river bank"
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "kjarni_tpu_torch", "embed", sentence,
                        "--model", str(mini), "--format", "json"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    secs["subprocess_embed"] = time.perf_counter() - t0
    check(r.returncode == 0, f"python -m kjarni_tpu_torch embed exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    sub = np.asarray(json.loads(r.stdout)["embedding"], dtype=np.float32)
    here = np.asarray(Embedder(str(mini)).embed(sentence), dtype=np.float32)
    row["embed_subprocess_max_abs_err"] = float(np.abs(sub - here).max())
    check(row["embed_subprocess_max_abs_err"] <= SURFACE_EMBED_TOL,
          f"subprocess embed within {SURFACE_EMBED_TOL} of the in-process Embedder "
          f"({row['embed_subprocess_max_abs_err']})")

    # the port's libkjarni.so through ctypes, in this process
    t0 = time.perf_counter()
    lib_path = ffi_build.build_library()
    secs["ffi_build"] = time.perf_counter() - t0
    L = _ctypes_lib(lib_path)
    check(L.kjarni_init() == 0, f"kjarni_init: {L.kjarni_last_error().decode()}")
    before = _counts()
    h = timed("abi_new", lambda: L.kjarni_new(
        b"generator", json.dumps({"model": str(d), "quantize": "int4"}).encode()))
    check(h > 0, f"kjarni_new generator: {L.kjarni_last_error().decode()}")
    args = json.dumps({"prompt": text, "preset": "greedy", "max_length": 4096,
                       "max_new_tokens": SURFACE_NEW_TOKENS}).encode()
    p = timed("abi_call", lambda: L.kjarni_call(h, b"generate", args))
    check(bool(p), f"kjarni_call generate: {L.kjarni_last_error().decode()}")
    abi_text = json.loads(ctypes.string_at(p).decode())["text"]
    L.kjarni_string_free(p)

    def pull():
        check(L.kjarni_stream_start(h, b"generate_stream", args) == 0,
              f"kjarni_stream_start: {L.kjarni_last_error().decode()}")
        out = []
        while (q := L.kjarni_stream_next(h)):
            out.append(ctypes.string_at(q).decode())
            L.kjarni_string_free(q)
        return out
    pieces = timed("abi_stream", pull)
    L.kjarni_free(h)
    got = [a - b for a, b in zip(_counts(), before)]
    check(got[0] > 0 and got[1] > 0, f"the C ABI launched flash {got[0]} and int4 {got[1]}")
    check(abi_text == want["abi_700"], "kjarni_call generate's text equals Generator's")
    check("".join(pieces) == want["abi_stream"],
          f"the C ABI's stream equals Generator's: {''.join(pieces)[:200]!r} against "
          f"{want['abi_stream'][:200]!r}")
    row.update(abi_flash_launches=got[0], abi_int4_launches=got[1], abi_stream_pieces=len(pieces))
    gc.collect()
    torch.cuda.empty_cache()

    # the port's compiled C host, as a subprocess, on the card
    clf, small = tmp / "distilbert-sentiment", tmp / "llama-small"
    t0 = time.perf_counter()
    write_encoder_dir(clf, DISTILBERT_SST2, seed=22)
    write_model_dir(small, seed=5, c=TINY_LLAMA)
    write_tokenizer(small / "tokenizer.json", TINY_LLAMA["vocab_size"])
    secs["write_dirs"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    host = ffi_build.build_test_host()
    r = subprocess.run([str(host), str(mini), str(clf), str(small), "cuda"],
                       capture_output=True, text=True, timeout=600, env=_python_env())
    secs["c_host"] = time.perf_counter() - t0
    check(r.returncode == 0 and r.stdout.startswith("OK "),
          f"the C host exited {r.returncode}: {r.stdout[-500:]} {r.stderr[-2000:]}")
    row["c_host"] = r.stdout.strip()
    row["seconds"] = secs
    # each surface's seconds beyond the Python API's for the same step (the
    # CLI's include its model load)
    row["overhead_s"] = {
        "cli_700": secs["cli_700"] - secs["api_load"] - secs["api_cli_700"],
        "cli_60": secs["cli_60"] - secs["api_load"] - secs["api_cli_60"],
        "abi_new": secs["abi_new"] - secs["api_load"],
        "abi_call": secs["abi_call"] - secs["api_abi_700"],
        "abi_stream": secs["abi_stream"] - secs["api_abi_stream"]}
    print(json.dumps(row))
    return row

# ---------------------------------------------------------------------------
# phase 17: parallelism (tp, dp, pp, sp over torch.distributed)
# ---------------------------------------------------------------------------

PAR_NEW_TOKENS = 32
PAR_TIE_BAND = SERVE_TIE_BAND       # teacher-forced logit margins, as in phase 8
PAR_F32_TOL = 1e-4                  # of the largest f32 logit, as phase 15 holds f32
PAR_DP_F32_ATOL = 1e-5              # dp rows against dp = 1, f32
PAR_TIMEOUT_S = 600                 # one group's whole run
PAR_SEQ = 1024
PAR_LAYERS = 4                      # the decoder's depth here: full width, cut depth


def compute_mode() -> str:
    """The card's compute mode: ranks sharing one card need "Default"."""
    return subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def _rank_main(rank: int, world: int, init: str, jobs: list, results) -> None:
    """One rank of a spawned group: gloo over a file rendezvous, every rank
    on cuda:0, the `_par_<name>` jobs in order. Each job's launches are its
    own main-path kernel launches (a job puts back those it makes for a
    reference or a timing)."""
    import datetime
    import traceback
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=300))
        out = {}
        for name, args in jobs:
            before, t = _all_counts(), time.perf_counter()
            out[name] = globals()[f"_par_{name}"](*args)
            out[name]["launches"] = [a - b for a, b in zip(_all_counts(), before)]
            out[name]["job_s"] = time.perf_counter() - t
            gc.collect()
            torch.cuda.empty_cache()
        results.put((rank, True, out))
    except BaseException:   # reported to the parent, which fails the phase
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn_ranks(world: int, tmp: Path, jobs: list) -> list:
    """Run `jobs` on `world` spawned ranks sharing cuda:0; each rank's
    results, in rank order. Any rank that fails or does not answer in
    PAR_TIMEOUT_S fails the phase; every rank is stopped before return."""
    import multiprocessing as mp
    import queue
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = tmp / f"rendezvous-{world}-{time.monotonic_ns()}"
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(init), jobs, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    deadline = time.monotonic() + PAR_TIMEOUT_S
    try:
        while len(got) < world and not errors:
            try:
                rank, ok, value = results.get(timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                errors.append(f"ranks {sorted(set(range(world)) - set(got))} did not "
                              f"answer in {PAR_TIMEOUT_S} s")
                break
            if ok:
                got[rank] = value
            else:
                errors.append(f"rank {rank} failed:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=5 if errors else 60)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    check(not errors, "; ".join(errors))
    return [got[r] for r in range(world)]


def _job_seconds(*groups) -> dict:
    """Each rank job's seconds, the slowest rank's, by group size."""
    return {f"{len(g)}:{job}": max(r[job]["job_s"] for r in g) for g in groups for job in g[0]}


def _leaves(tree):
    """The tensors of a param tree."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif hasattr(tree, "nbytes"):
        yield tree


def _par_prefill(lm, ids: list):
    """One from-zero prefill of ids at its seq bucket over a fresh cache of
    this rank's KV heads (flash at a bucket >= 512): logits [V]."""
    import torch
    from kjarni_tpu_torch.core.bucketing import seq_bucket
    bucket = seq_bucket(len(ids), lm.max_context)
    x = torch.zeros(1, bucket, dtype=torch.long, device=lm.device)
    x[0, :len(ids)] = torch.tensor(ids, device=lm.device)
    ck, cv = lm._new_cache(1, bucket)
    with torch.inference_mode():
        return lm.family.forward(lm.params, lm.config, x, ck, cv, 0, len(ids) - 1,
                                 use_flash=lm._flash_ok and bucket >= lm._flash_min_seq,
                                 **lm.fwd_kw)[0][0]


def _par_tp(model: str, quantize, prompt: str) -> dict:
    """DecoderLM(tp=world) on the 701-token prompt: PAR_NEW_TOKENS greedy
    ids streamed, the prefill's median ms over 3 more calls, decode tok/s."""
    import torch
    import torch.distributed as dist
    from kjarni_tpu_torch.generate.sampling import GenerationConfig
    from kjarni_tpu_torch.models.decoder_lm import DecoderLM
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = DecoderLM(model, quantize=quantize, tp=dist.get_world_size())
    load_s = time.perf_counter() - t0
    # what loading held on the card at most, against the shard it keeps
    load_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    shard_gb = sum(t.nbytes for t in _leaves(lm.params)
                   if t.device.type == "cuda") / 1e9
    ids = lm.encode_prompt(prompt)
    check(lm.device.type == "cuda" and lm._flash_ok, "tp: the model on the card, flash on")
    cfg = GenerationConfig.greedy(max_new_tokens=PAR_NEW_TOKENS, max_length=4096)
    torch.cuda.reset_peak_memory_stats()
    f0, i0, _ = _all_counts()
    torch.cuda.synchronize()
    t, first, out = time.perf_counter(), None, []
    for st in lm.generate_stream(token_ids=ids, config=cfg):
        first = first or time.perf_counter()
        out.append(st.id)
    end = time.perf_counter()
    flash_n, int4_n = _all_counts()[0] - f0, _all_counts()[1] - i0
    layers = lm.config.num_layers
    check(flash_n == layers, f"tp: {flash_n} flash launches on a rank's prefill")
    want = int4_per_forward(layers) * (1 + len(out)) if quantize == "int4" else 0
    check(int4_n == want, f"tp: {int4_n} int4 launches on a rank, expected {want}")
    counts = _all_counts()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _par_prefill(lm, ids)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t1))
    prefill_ms = statistics.median(times)
    _restore(counts)
    # the transport alone: one all-reduce of a decode step's hidden state
    # (o and down each take one per layer) and of the 1024 prefill's, and the
    # decode step's as a host tensor (gloo without the card's copies)
    comm = lm.tp
    allreduce_ms = {}
    hid = lm.config.hidden_size
    for name, shape, dev in (("decode", (1, 1, hid), lm.device),
                             ("prefill", (1, 1024, hid), lm.device),
                             ("decode_host_tensor", (1, 1, hid), "cpu")):
        x = torch.ones(shape, dtype=lm._cache_dtype, device=dev)
        ar = []
        for _ in range(20):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            comm.all_reduce(x.clone())
            torch.cuda.synchronize()
            ar.append(1e3 * (time.perf_counter() - t1))
        allreduce_ms[name] = statistics.median(ar[5:])
    q = lm.params["layers"]["q"]
    return {"ids": out, "prompt_len": len(ids), "load_s": load_s,
            "allreduce_ms": allreduce_ms,
            "ttft_ms": 1e3 * (first - t), "decode_tok_s": (len(out) - 1) / (end - first),
            "prefill_ms": prefill_ms,
            "q_cols": (q["w4"] if "w4" in q else q["w"]).shape[-1],
            "transport": lm.tp.transport(lm.device), "load_peak_gb": load_peak_gb,
            "shard_gb": shard_gb, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _par_tp_f32(model: str, prompt: str) -> dict:
    """f32 DecoderLM(tp=world) over the 2-layer dir: the prompt's prefill
    logits (the f32 flash kernel on this rank's heads)."""
    import torch.distributed as dist
    from kjarni_tpu_torch.models.decoder_lm import DecoderLM
    lm = DecoderLM(model, dtype="f32", tp=dist.get_world_size())
    return {"logits": _par_prefill(lm, lm.encode_prompt(prompt)).float().cpu().numpy()}


def _par_dp(model: str, texts: list) -> dict:
    """SentenceEncoder(dp=world) on the texts, f32 and bf16, and bf16
    texts/s (median of 3 calls)."""
    import torch
    import torch.distributed as dist
    from kjarni_tpu_torch.models.encoder_models import SentenceEncoder
    n = dist.get_world_size()
    f32 = SentenceEncoder(model, dtype="f32", dp=n).encode_batch(texts)
    enc = SentenceEncoder(model, dp=n)
    bf16 = enc.encode_batch(texts)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        enc.encode_batch(texts)
        times.append(time.perf_counter() - t)
    return {"f32": f32, "bf16": bf16, "texts_per_s": len(texts) / statistics.median(times),
            "transport": enc._dp.transport(enc.device)}


def _par_params(model: str):
    import torch
    from kjarni_tpu_torch.models import llama as kllama
    from kjarni_tpu_torch.weights.safetensors_loader import ModelWeights
    cfg = kllama.DecoderConfig.from_hf(json.loads((Path(model) / "config.json").read_text()))
    return cfg, kllama.load_params(ModelWeights(model), cfg, torch.bfloat16,
                                   rope_cache_len=2 * PAR_SEQ, device="cuda")


def _par_band(params, cfg, ids, logits) -> dict:
    """The one-process plain forward over ids [B, S] (no kernel): each
    position's margin max(ref) - ref[argmax(logits)], and the largest
    |logits - ref|."""
    import torch
    from kjarni_tpu_torch.models import llama as kllama
    counts = _all_counts()
    B, S = ids.shape
    margins, diff = [], 0.0
    with torch.inference_mode():
        for b in range(B):
            ck, cv = kllama.init_cache(cfg, 1, S, torch.bfloat16, "cuda")
            ref = kllama.forward_all_logits(params, cfg, ids[b:b + 1], ck, cv, 0)[0][0]
            ref = ref.float()
            got = logits[b].float()
            pick = got.argmax(-1)
            margins.append((ref.max(-1).values - ref.gather(-1, pick[:, None])[:, 0]).max().item())
            diff = max(diff, (got - ref).abs().max().item())
            del ref, got, ck, cv
    _restore(counts)
    return {"band_max": max(margins), "max_abs_diff": diff}


def _par_pp(model: str, ids) -> dict:
    """pipeline_forward (n_micro 4, B 4 at S 1024) and pp_generate
    (PAR_NEW_TOKENS on B 2) over a ("pp",) mesh of every rank, each stage
    holding its layers; rank 0 holds both in the tie band of one process."""
    import torch
    import torch.distributed as dist
    from kjarni_tpu_torch.parallel.mesh import shard_params_with
    from kjarni_tpu_torch.parallel.pipeline import (make_pp_mesh, pipeline_forward,
                                                    pp_generate, pp_param_sharding)
    cfg, params = _par_params(model)
    mesh = make_pp_mesh(dist.get_world_size())
    local = shard_params_with(params, pp_param_sharding(mesh), mesh)
    if dist.get_rank():
        del params
    x = torch.tensor(ids, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits = pipeline_forward(local, cfg, x, mesh, n_micro=4)
    torch.cuda.synchronize()
    fwd_ms = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    toks = pp_generate(local, cfg, x[:2], mesh, PAR_NEW_TOKENS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    out = {"forward_ms": fwd_ms, "generate_s": gen_s,
           "decode_tok_s": toks.numel() / gen_s, "layers_here": local["layers"]["q"]["w"].shape[0],
           "transport": mesh.comm("pp").transport("cuda")}
    if dist.get_rank() == 0:
        out["forward"] = _par_band(params, cfg, x, logits)
        full = torch.cat([x[:2], toks[:, :-1]], dim=1)
        rows = [torch.arange(PAR_SEQ - 1, PAR_SEQ - 1 + PAR_NEW_TOKENS)] * 2
        out["generate"] = _par_teacher_forced(params, cfg, full, toks, rows)
    return out


def _par_teacher_forced(params, cfg, full, toks, rows) -> dict:
    """The margins of the generated ids in the one-process plain forward over
    prompt + generated ids (phase 8's teacher-forced band)."""
    import torch
    from kjarni_tpu_torch.models import llama as kllama
    counts = _all_counts()
    margins = []
    with torch.inference_mode():
        for b in range(full.shape[0]):
            ck, cv = kllama.init_cache(cfg, 1, full.shape[1], torch.bfloat16, "cuda")
            ref = kllama.forward_all_logits(params, cfg, full[b:b + 1], ck, cv, 0)[0][0]
            ref = ref[rows[b].to(ref.device)].float()
            margins += _margins(ref, toks[b].tolist())
    _restore(counts)
    return {"band_max": max(margins)}


def _par_sp(model: str, ids) -> dict:
    """sequence_parallel_forward over B 1 at S 1024 on an ("sp",) mesh of
    every rank; rank 0 holds its logits in the tie band of one process."""
    import torch
    import torch.distributed as dist
    from kjarni_tpu_torch.parallel.sequence import make_sp_mesh, sequence_parallel_forward
    cfg, params = _par_params(model)
    mesh = make_sp_mesh(dist.get_world_size())
    x = torch.tensor(ids, device="cuda")
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = sequence_parallel_forward(params, cfg, x, mesh)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    out = {"forward_ms": min(times), "transport": mesh.comm("sp").transport("cuda")}
    if dist.get_rank() == 0:
        out["forward"] = _par_band(params, cfg, x, logits)
    return out


PAR_SERVE_NEW_TOKENS = 8
PAR_SERVE_CLIENTS = 4
PAR_FAMILY_F32_TOL = 1e-4           # of the largest tp = 1 value (tests/test_parallel.py's)
# the encoder families held at tp = 2 (phase 17): name, config, rule, encoder input
PAR_FAMILIES = ("minilm", "distilbart-cnn", "flan-t5-base", "whisper-small")


def _serve_clients(models: dict, engine_kw: dict, warm: tuple, requests: list,
                   cache: dict | None = None) -> dict | None:
    """serve.serve on rank 0 of this group (port 0) answering `requests`
    [(path, body)] from concurrent HTTP clients, every model call issued
    through its Dispatcher to every rank (serve_spmd.py); the other ranks
    follow until rank 0 stops them, as serve.run does on SIGINT. The `warm`
    request runs alone first: it builds the model (lazily, on every rank)
    unless `cache`, a model cache an earlier server on this rank filled,
    holds it already. Rank 0's answers, each request's seconds and the first
    request's; None elsewhere."""
    import threading
    import urllib.request
    import torch.distributed as dist
    from kjarni_tpu_torch import serve
    from kjarni_tpu_torch.serve_spmd import follow
    if dist.get_rank() != 0:
        engine = serve._Engine(models, **engine_kw)
        engine._cache = engine._cache if cache is None else cache
        follow(engine._apply)
        return None
    srv = serve.serve("127.0.0.1", 0, models, **engine_kw)
    srv.engine._cache = srv.engine._cache if cache is None else cache
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    got, secs = [None] * len(requests), [None] * len(requests)

    def one(i, path, body):
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=PAR_TIMEOUT_S) as r:
            got[i] = (r.status, json.loads(r.read()))
        secs[i] = time.perf_counter() - t
    first = time.perf_counter()
    try:
        req = urllib.request.Request(base + warm[0], data=json.dumps(warm[1]).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=PAR_TIMEOUT_S) as r:
            check(r.status == 200, f"served the first request: {r.status}")
        first = time.perf_counter() - first
        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i, p, b))
                   for i, (p, b) in enumerate(requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    finally:
        srv.shutdown()
        srv.server_close()
        srv.engine._spmd.stop()
    check(all(g is not None and g[0] == 200 for g in got), f"served: {got}")
    return {"answers": [g[1] for g in got], "seconds": secs, "wall_s": wall, "first_s": first}


def _par_serve(model: str, prompt: str, runs: list) -> dict:
    """The tp server under SPMD, one server per run (tag, engine keywords,
    route): PAR_SERVE_CLIENTS concurrent greedy requests of the prompt for
    PAR_SERVE_NEW_TOKENS. The batch scheduler takes /v1/completions, whose
    max_length is the context (/v1/generate's preset keeps GenerationConfig's
    100, under the 701-token prompt), the continuous one /v1/generate. The
    servers share one model cache: the model is built once, by the first."""
    bodies = {"/v1/completions": {"prompt": prompt, "max_tokens": PAR_SERVE_NEW_TOKENS,
                                  "temperature": 0},
              "/v1/generate": {"prompt": prompt, "preset": "greedy",
                               "max_new_tokens": PAR_SERVE_NEW_TOKENS}}
    out, cache = {}, {}
    for tag, engine_kw, route in runs:
        warm = (route, {**bodies[route], "max_tokens": 1} if "max_tokens" in bodies[route]
                else {**bodies[route], "max_new_tokens": 1})
        out[tag] = _serve_clients({"generate": model}, engine_kw, warm,
                                  [(route, bodies[route])] * PAR_SERVE_CLIENTS, cache)
    return out


def _par_serve_embed(model: str, texts: list) -> dict:
    """/v1/embed on a dp = world server: two concurrent clients with half the
    texts each, on the server as it runs (its Embedder takes no dtype: bf16
    on the card), then on one whose encoder is built in f32, so that its
    rows can be held to dp = 1's f32 rows."""
    import functools
    from kjarni_tpu_torch.tasks import embedder
    import torch.distributed as dist
    half = len(texts) // 2

    def served():
        return _serve_clients({"embed": model}, {"dp": dist.get_world_size()},
                              ("/v1/embed", {"text": texts[0]}),
                              [("/v1/embed", {"texts": texts[:half]}),
                               ("/v1/embed", {"texts": texts[half:]})]) or {}
    out = {"bf16": served()}
    saved = embedder.SentenceEncoder
    embedder.SentenceEncoder = functools.partial(saved, dtype="f32")
    try:
        out["f32"] = served()
    finally:
        embedder.SentenceEncoder = saved
    return out


def _family_inputs(name: str, c: dict) -> dict:
    """Seeded inputs of one family's forward: token ids (and a decoder
    prefix), or a log-mel for Whisper."""
    import torch
    g = torch.Generator().manual_seed(23)
    if name == "minilm":
        ids = torch.randint(1000, c["vocab_size"], (2, EMBED_SEQ), generator=g)
        mask = torch.ones_like(ids)
        mask[1, EMBED_SEQ // 2:] = 0
        return {"ids": ids, "mask": mask}
    if name == "whisper-small":
        return {"mel": torch.randn(1, c["num_mel_bins"], 3000, generator=g) * 0.5,
                "dec": torch.tensor([[50258, 50259, 50359, 50363]])}
    ids = torch.randint(5, c["vocab_size"] - 1, (1, 128), generator=g)
    return {"ids": ids, "mask": torch.ones_like(ids),
            "dec": torch.tensor([[c["decoder_start_token_id"], 10, 11, 12]])}


def family_forward(name: str, d: str, dtype, tp=None, mesh=None, flash: bool = False) -> dict:
    """One encoder family's forward on the card over dir d: MiniLM's hidden
    states; an encoder-decoder's encoder states and one decode_step's logits
    (4 tokens from slot 0). With a mesh: this rank's shard under the
    family's rule, the collectives over `tp`."""
    import torch
    from kjarni_tpu_torch.parallel import mesh as pm
    from kjarni_tpu_torch.weights.safetensors_loader import ModelWeights
    family = {"minilm": "bert", "distilbart-cnn": "bart", "flan-t5-base": "t5",
              "whisper-small": "whisper"}[name]
    mod = importlib.import_module(f"kjarni_tpu_torch.models.{family}")
    conf = {"bert": "BertConfig", "t5": "T5Config", "bart": "BartConfig",
            "whisper": "WhisperConfig"}[family]
    c = json.loads((Path(d) / "config.json").read_text())
    cfg = getattr(mod, conf).from_hf(c)
    params = mod.load_params(ModelWeights(d), cfg, dtype, "cpu")
    if mesh is not None:
        rule = {"bert": pm.encoder_param_sharding, "t5": pm.t5_param_sharding,
                "bart": pm.bart_param_sharding, "whisper": pm.whisper_param_sharding}[family]
        params = pm.shard_params_with(params, rule(mesh), mesh)
    params = _to_card(params)
    x = {k: v.cuda() for k, v in _family_inputs(name, c).items()}
    with torch.inference_mode():
        if family == "bert":
            return {"enc": mod.encode(params, cfg, x["ids"], x["mask"], tp=tp)}
        if family == "whisper":
            enc = mod.encode(params, cfg, x["mel"].to(dtype), use_flash=flash, tp=tp)
            mask = None
        else:
            mask = x["mask"]
            enc = mod.encode(params, cfg, x["ids"], mask, tp=tp)
        out = {"enc": enc}
        if not flash:
            ck, cv = mod.precompute_cross_kv(params, cfg, enc, tp=tp)
            sk, sv = mod.init_self_cache(cfg, 1, 8, dtype, "cuda")
            if tp is not None:
                sk, sv = (t.narrow(2, tp.rank * ck.shape[2], ck.shape[2]).contiguous()
                          for t in (sk, sv))
            out["logits"] = mod.decode_step(params, cfg, x["dec"], sk, sv, ck, cv, mask, 0,
                                            tp=tp)[0]
        return out


def _tree_map(fn, tree):
    """fn over every tensor of a param tree (None leaves stay None)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree if tree is None else fn(tree)


def _to_card(tree):
    return _tree_map(lambda t: t.cuda(), tree)


def _par_families(dirs: dict) -> dict:
    """Each encoder family's tp = world forward (family_forward) in f32, and
    whisper-small's encoder in bf16 on the flash kernel at this rank's
    heads: the outputs as host arrays, with seconds and the flash launches."""
    import torch
    import torch.distributed as dist
    from kjarni_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(dp=1, tp=dist.get_world_size())
    tp = mesh.comm("tp")
    out = {}
    for name in PAR_FAMILIES:
        t = time.perf_counter()
        got = family_forward(name, dirs[name], torch.float32, tp, mesh)
        out[name] = {k: v.float().cpu().numpy() for k, v in got.items()}
        out[name]["seconds"] = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
    f0 = _all_counts()[0]
    got = family_forward("whisper-small", dirs["whisper-small"], torch.bfloat16, tp, mesh,
                         flash=True)
    out["whisper-small-bf16-flash"] = {"enc": got["enc"].float().cpu().numpy(),
                                       "flash_launches": _all_counts()[0] - f0}
    return out


def _frame_cos_min(a, b) -> float:
    """The smallest cosine between matching rows (frames) of two [.., D] arrays."""
    import numpy as np
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    return float(cos.min())


def hold_families(dirs: dict, two: list) -> dict:
    """The tp = 2 family outputs against one process on the card: f32 within
    PAR_FAMILY_F32_TOL of the largest tp = 1 value, Whisper's bf16 flash
    encoder within WHISPER_FLASH_COS_MIN (per frame) of tp = 1's."""
    import numpy as np
    import torch
    counts = _all_counts()
    rows = {}
    for name in PAR_FAMILIES:
        ref = {k: v.float().cpu().numpy()
               for k, v in family_forward(name, dirs[name], torch.float32).items()}
        row = {"seconds": two[0]["families"][name]["seconds"]}
        for k, want in ref.items():
            tol = PAR_FAMILY_F32_TOL * float(np.abs(want).max())
            err = max(float(np.abs(r["families"][name][k] - want).max()) for r in two)
            check(err <= tol, f"tp = 2 {name} {k}: f32 within {tol} of tp = 1 ({err})")
            row[f"{k}_max_abs_err"], row[f"{k}_tol"] = err, tol
        rows[name] = row
        gc.collect()
        torch.cuda.empty_cache()
    ref = family_forward("whisper-small", dirs["whisper-small"], torch.bfloat16,
                         flash=True)["enc"].float().cpu().numpy()
    _restore(counts)
    runs = [r["families"]["whisper-small-bf16-flash"] for r in two]
    cos = min(_frame_cos_min(r["enc"], ref) for r in runs)
    check(cos >= WHISPER_FLASH_COS_MIN,
          f"tp = 2 whisper-small bf16 flash encoder: cosine {cos} >= {WHISPER_FLASH_COS_MIN}")
    n = WHISPER_SMALL["encoder_layers"]
    check(all(r["flash_launches"] == n for r in runs),
          f"tp = 2 whisper encoder: {n} flash launches a rank ({[r['flash_launches'] for r in runs]})")
    rows["whisper-small-bf16-flash"] = {"cos_min": cos, "flash_launches_per_rank": n}
    return rows


def hold_served(tag: str, lm, prompt: str, served: dict) -> dict:
    """Each served answer teacher-forced on the one-process plain forward:
    every token within PAR_TIE_BAND of the reference's best."""
    p_ids = lm.encode_prompt(prompt)
    bands = []
    for a in served["answers"]:
        text = a["text"] if "text" in a else a["choices"][0]["text"]
        out = lm.tokenizer.encode(text, add_special_tokens=False)
        check(1 <= len(out) <= PAR_SERVE_NEW_TOKENS, f"{tag}: {len(out)} new tokens")
        ref = _teacher_forced(lm, p_ids + out[:-1],
                              list(range(len(p_ids) - 1, len(p_ids) - 1 + len(out))))
        bands.append(max(_margins(ref, out)))
    check(max(bands) <= PAR_TIE_BAND,
          f"{tag}: served answers' teacher-forced margins {bands} within {PAR_TIE_BAND}")
    return {"band_max": max(bands), "request_s": served["seconds"], "wall_s": served["wall_s"],
            "first_request_s": served["first_s"]}


def phase_parallel(d: Path, tmp: Path) -> dict:
    """Phase 17 (see the module docstring): ranks spawned as processes that
    share cuda:0 over gloo, staged through host memory, each returning its
    results and its kernel launches; held against one process on the card."""
    import numpy as np
    import torch
    from kjarni_tpu_torch.models.decoder_lm import DecoderLM
    from kjarni_tpu_torch.models.encoder_models import SentenceEncoder
    from kjarni_tpu_torch.ops.kernels.flash_attention import flash_attention
    from kjarni_tpu_torch.ops.kernels.int4_matvec import int4_matvec
    mode = compute_mode()
    check(mode == "Default", f"ranks sharing one card need compute mode Default; the card "
                             f"reads {mode}, so a second process cannot open it")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    prompt = _prompt(700, 1)
    # the phase-3 weights cut to their first layers: d4 for the decoder's
    # paths, d2 for the f32 prefill
    d4, d2 = (layers_view(d, tmp / f"llama-3.2-1b-{n}-layers-parallel", n)
              for n in (PAR_LAYERS, 2))
    mini = tmp / "minilm-l6-parallel"
    write_encoder_dir(mini, MINILM_L6)
    fam = {"minilm": str(mini)}
    for name, c in (("distilbart-cnn", DISTILBART_CNN), ("flan-t5-base", FLAN_T5_BASE),
                    ("whisper-small", WHISPER_SMALL)):
        write_encdec_dir(tmp / f"{name}-parallel", c, seed=5)
        fam[name] = str(tmp / f"{name}-parallel")
    parent_s = {"write_dirs": time.perf_counter() - t0}
    # the tp = 4 int4 server's model: an int4 native checkpoint (the server
    # takes no quantize option)
    from kjarni_tpu_torch.weights.checkpoint import convert_model
    t0 = time.perf_counter()
    counts = _all_counts()
    int4_dir = convert_model(d4, tmp / "llama-3.2-1b-int4-ckpt", quantize="int4")
    _restore(counts)
    gc.collect()
    torch.cuda.empty_cache()
    parent_s["int4_ckpt"] = time.perf_counter() - t0
    texts = _sentences(EMBED_BATCH, 40, EMBED_SEQ - 2, 7)
    g = torch.Generator().manual_seed(17)
    ids = torch.randint(1000, 120000, (4, PAR_SEQ), generator=g).numpy()
    t0 = time.perf_counter()
    serve_runs = [("tp2_batch", {"tp": 2}, "/v1/completions"),
                  ("tp2_continuous", {"tp": 2, "scheduler": "continuous"}, "/v1/generate")]
    two = _spawn_ranks(2, tmp, [("tp", (str(d4), None, prompt)), ("tp_f32", (str(d2), prompt)),
                                ("dp", (str(mini), texts)), ("pp", (str(d4), ids)),
                                ("sp", (str(d4), ids[:1])), ("serve", (str(d4), prompt, serve_runs)),
                                ("serve_embed", (str(mini), texts)), ("families", (fam,))])
    two_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    four = _spawn_ranks(4, tmp, [("tp", (str(d4), "int4", prompt)),
                                 ("serve", (str(int4_dir), prompt,
                                            [("tp4_int4", {"tp": 4}, "/v1/completions")]))])
    four_s = time.perf_counter() - t0
    launches = [sum(r[job]["launches"][k] for group in (two, four) for r in group
                    for job in r) for k in range(3)]
    where = (f"ranks sharing one card ({card}) over gloo staged through host memory, "
             f"not a scale-out number")
    rows = {}
    # the references: one process on the same card; their launches are not
    # the main path's
    t0 = time.perf_counter()
    counts = _all_counts()
    for tag, group, quantize in (("tp2_bf16", two, None), ("tp4_int4", four, "int4")):
        runs = [r["tp"] for r in group]
        check(all(r["ids"] == runs[0]["ids"] for r in runs),
              f"{tag}: every rank returns the same ids")
        lm = DecoderLM(d4, quantize=quantize)
        p_ids = lm.encode_prompt(prompt)
        out = runs[0]["ids"]
        check(len(out) == PAR_NEW_TOKENS, f"{tag}: {len(out)} new tokens")
        ref = _teacher_forced(lm, p_ids + out[:-1],
                              list(range(len(p_ids) - 1, len(p_ids) - 1 + len(out))))
        band = max(_margins(ref, out))
        check(band <= PAR_TIE_BAND, f"{tag}: teacher-forced margin {band} within "
                                    f"{PAR_TIE_BAND} of tp = 1")
        rows[tag] = {"band_max": band, **{k: runs[0][k] for k in (
            "prompt_len", "load_s", "ttft_ms", "decode_tok_s", "prefill_ms", "allreduce_ms",
            "q_cols", "transport", "load_peak_gb", "shard_gb", "peak_gb")},
            "launches_per_rank": runs[0]["launches"]}
        for stag, served in group[0]["serve"].items():
            if stag in ("launches", "job_s"):
                continue
            rows[f"serve_{stag}"] = hold_served(f"served {stag}", lm, prompt, served)
        del lm, ref
        gc.collect()
        torch.cuda.empty_cache()
    lm = DecoderLM(d2, dtype="f32")
    ref = _par_prefill(lm, lm.encode_prompt(prompt)).float().cpu().numpy()
    del lm
    tol = PAR_F32_TOL * float(np.abs(ref).max())
    errs = [float(np.abs(r["tp_f32"]["logits"] - ref).max()) for r in two]
    check(max(errs) <= tol, f"f32 tp = 2 (2 layers): logits within {tol} of tp = 1 ({errs})")
    rows["tp2_f32_2layers"] = {"max_abs_err": max(errs), "tol": tol,
                               "launches_per_rank": two[0]["tp_f32"]["launches"]}
    ref32 = SentenceEncoder(mini, dtype="f32").encode_batch(texts)
    dp_err = max(float(np.abs(r["dp"]["f32"] - ref32).max()) for r in two)
    cos = min(float((r["dp"]["bf16"] * ref32).sum(-1).min()) for r in two)
    check(dp_err <= PAR_DP_F32_ATOL, f"dp = 2 f32 rows within {PAR_DP_F32_ATOL} ({dp_err})")
    check(cos >= EMBED_COS_MIN, f"dp = 2 bf16 rows: cosine {cos} >= {EMBED_COS_MIN}")
    rows["dp2_minilm"] = {"f32_max_abs_err": dp_err, "bf16_cos_min": cos,
                          "texts_per_s": two[0]["dp"]["texts_per_s"],
                          "transport": two[0]["dp"]["transport"]}
    served = two[0]["serve_embed"]

    def rows_of(run):
        return np.asarray([v for a in run["answers"] for v in a["embeddings"]], np.float32)
    embed_err = float(np.abs(rows_of(served["f32"]) - ref32).max())
    check(embed_err <= PAR_DP_F32_ATOL,
          f"dp = 2 /v1/embed f32 rows within {PAR_DP_F32_ATOL} of dp = 1 ({embed_err})")
    from kjarni_tpu_torch.tasks.embedder import Embedder
    ref16 = np.asarray(Embedder(str(mini)).embed_batch(texts), np.float32)
    embed_cos = _frame_cos_min(rows_of(served["bf16"]), ref16)
    check(embed_cos >= EMBED_COS_MIN,
          f"dp = 2 /v1/embed bf16 rows: cosine {embed_cos} >= {EMBED_COS_MIN} of dp = 1's")
    rows["serve_dp2_embed"] = {"f32_max_abs_err": embed_err, "bf16_cos_min": embed_cos,
                               "request_s": served["bf16"]["seconds"],
                               "first_request_s": served["bf16"]["first_s"]}
    rows["tp2_families"] = hold_families(fam, two)
    _restore(counts)
    parent_s["references"] = time.perf_counter() - t0
    pp, sp = two[0]["pp"], two[0]["sp"]
    for what, band in (("pp forward", pp["forward"]["band_max"]),
                       ("pp generate", pp["generate"]["band_max"]),
                       ("sp forward", sp["forward"]["band_max"])):
        check(band <= PAR_TIE_BAND, f"{what}: margin {band} within {PAR_TIE_BAND} of one process")
    check([r["pp"]["layers_here"] for r in two] == [PAR_LAYERS // 2] * 2,
          f"pp = 2: {PAR_LAYERS // 2} layers a stage")
    rows["pp2"] = {k: pp[k] for k in ("forward_ms", "generate_s", "decode_tok_s",
                                      "forward", "generate", "transport")}
    rows["sp2"] = {k: sp[k] for k in ("forward_ms", "forward", "transport")}
    check(launches[0] > 0 and launches[1] > 0,
          f"the ranks launched both kernels (flash, int4, f32 flash: {launches})")
    # the ranks' launches are this phase's main-path launches
    flash_attention.launches += launches[0]
    int4_matvec.launches += launches[1]
    flash_attention.launches_f32 += launches[2]
    row = {"parallel": rows, "layers": PAR_LAYERS, "two_ranks_s": two_s, "four_ranks_s": four_s,
           "job_s": _job_seconds(two, four), "parent_s": parent_s,
           "rank_launches": launches, "compute_mode": mode, "measured_as": where}
    print(json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# phase 18: the training step (kjarni_tpu_torch/parallel/train.py)
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 4, 256
TRAIN_LR = 1e-3
TRAIN_LOSS_RTOL = 1e-5          # f32 against f64, and dp x tp against one process
TRAIN_GRAD_TOL = 1e-4           # each leaf's max |g32 - g64|, of its max |g64|
TRAIN_PARAM_ATOL = 1e-7         # dp x tp params against one process: lr x 1e-4


def _train_batch(vocab: int):
    """B 4 x S 256 of seeded ids, labels the next id, a mask whose first two
    rows (the first dp rank's) drop their last quarter."""
    import torch
    g = torch.Generator().manual_seed(29)
    ids = torch.randint(1000, vocab, (TRAIN_B, TRAIN_S), generator=g)
    labels = torch.roll(ids, -1, dims=1)
    mask = torch.ones_like(ids)
    mask[:TRAIN_B // 2, TRAIN_S * 3 // 4:] = 0
    return ids, labels, mask


def _train_params(model: str, layers: int, dtype, device):
    """Llama-3.2-1B's config cut to `layers` and its first `layers` layers
    (a tied head: lm_head is embed.t()), rope tables of TRAIN_S rows."""
    from kjarni_tpu_torch.models import llama as kllama
    from kjarni_tpu_torch.weights.safetensors_loader import ModelWeights
    c = json.loads((Path(model) / "config.json").read_text())
    cfg = kllama.DecoderConfig.from_hf({**c, "num_hidden_layers": layers})
    return cfg, kllama.load_params(ModelWeights(model), cfg, dtype, rope_cache_len=TRAIN_S,
                                   device=device)


def _tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaves(v, path + (k,))
    else:
        yield "/".join(path), tree


def _par_train(model: str, batch: tuple) -> dict:
    """One sgd_train_step on a dp 2 x tp 4 mesh of the 8 ranks at 2 layers:
    the step's seconds and the bytes its collectives moved on this rank; on
    rank 0 the updated params gathered whole (gather_params) against one
    process's step on the same card."""
    import torch
    import torch.distributed as dist
    from kjarni_tpu_torch.parallel import comm as pc
    from kjarni_tpu_torch.parallel.mesh import (gather_params, llama_param_sharding,
                                                make_mesh, shard_llama_params)
    from kjarni_tpu_torch.parallel.train import sgd_train_step
    mesh = make_mesh(dp=2, tp=4)
    cfg, full = _train_params(model, 2, torch.float32, "cpu")
    params = _to_card(shard_llama_params(full, mesh))
    if dist.get_rank():
        del full
    rows = TRAIN_B // 2
    dpi = mesh.coords["dp"]
    mine = [t[dpi * rows:(dpi + 1) * rows].cuda() for t in batch]
    moved = {"all_reduce": 0, "all_gather": 0}
    real = {k: getattr(pc.Comm, k) for k in moved}

    def counting(kind):
        def call(self, x, *a, **kw):
            if self.size > 1:
                moved[kind] += x.numel() * x.element_size()
            return real[kind](self, x, *a, **kw)
        return call
    for k in moved:
        setattr(pc.Comm, k, counting(k))
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        new, loss = sgd_train_step(params, cfg, *mine, lr=TRAIN_LR, tp=mesh.comm("tp"),
                                   dp=mesh.comm("dp"))
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t
    finally:
        for k, f in real.items():
            setattr(pc.Comm, k, f)
    out = {"loss": float(loss), "step_s": step_s, "bytes": moved,
           "transport": mesh.comm("tp").transport("cuda")}
    gathered = gather_params(new, llama_param_sharding(mesh), mesh)
    if dist.get_rank() == 0:
        ref, ref_loss = sgd_train_step(_to_card(full), cfg, *[t.cuda() for t in batch],
                                       lr=TRAIN_LR)
        want = dict(_tree_leaves(ref))
        out["ref_loss"] = float(ref_loss)
        out["param_max_abs_err"] = {k: float((v - want[k]).abs().max())
                                    for k, v in _tree_leaves(gathered)}
    return out


def _par_dryrun() -> dict:
    """Phases 1-4 of the dry run (parallel/dryrun.py) on this group."""
    import torch.distributed as dist
    from kjarni_tpu_torch.parallel.dryrun import run_phases
    return run_phases(dist.get_world_size(), "cuda")


def _par_dryrun_product(model: str) -> dict:
    """Phase 5 of the dry run: DecoderLM(tp=4)'s greedy text and one process's."""
    from kjarni_tpu_torch.parallel.dryrun import product_texts
    return product_texts(model, "cuda")


def phase_train(d: Path, tmp: Path) -> dict:
    """Phase 18 (see the module docstring): the training step, which runs
    no kernel (plain attention, as the JAX package's loss)."""
    import torch
    from kjarni_tpu_torch.parallel.dryrun import write_product_dir
    from kjarni_tpu_torch.parallel.train import loss_and_grads, sgd_train_step
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 off: f32 matmuls are f32")
    cfg, p32 = _train_params(str(d), LLAMA_1B["num_hidden_layers"], torch.float32, "cuda")
    batch = _train_batch(cfg.vocab_size)
    x = [t.cuda() for t in batch]
    loss32, g32 = loss_and_grads(p32, cfg, *x)
    g32 = dict(_tree_leaves(g32))
    # loss_and_grads was the warm-up: the step is timed once
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    new, loss = sgd_train_step(p32, cfg, *x, lr=TRAIN_LR)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t)
    del new
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(float(loss) == float(loss32), "the step's loss is loss_and_grads'")
    p64 = _tree_map(lambda t: t.double(), p32)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    loss64, g64 = loss_and_grads(p64, cfg, *x)
    del p64
    loss_rel = abs(float(loss32) - float(loss64)) / abs(float(loss64))
    check(loss_rel <= TRAIN_LOSS_RTOL, f"train f32 loss within {TRAIN_LOSS_RTOL} of f64 "
                                       f"({loss_rel})")
    grad_rel = {}
    for k, v in _tree_leaves(g64):
        top = float(v.abs().max())
        err = float((g32[k].double() - v).abs().max())
        grad_rel[k] = err / top if top else err
        check(grad_rel[k] <= TRAIN_GRAD_TOL,
              f"train gradient {k}: max |g32 - g64| {err} <= {TRAIN_GRAD_TOL} of {top}")
    check(float(g64["lm_head"].abs().max()) > 0 and float(g64["rope_cos"].abs().max()) > 0,
          "the tied head and the rope tables take gradients of their own")
    del g32, g64
    gc.collect()
    torch.cuda.empty_cache()
    # dp 2 x tp 4 on 8 ranks sharing the card, and the dry run's phases 1-4
    t0 = time.perf_counter()
    eight = _spawn_ranks(8, tmp, [("train", (str(d), batch)), ("dryrun", ())])
    eight_s = time.perf_counter() - t0
    r0 = eight[0]["train"]
    check(all(r["train"]["loss"] == r0["loss"] for r in eight), "every rank's loss the same")
    rel = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
    check(rel <= TRAIN_LOSS_RTOL, f"dp 2 x tp 4 loss within {TRAIN_LOSS_RTOL} of one "
                                  f"process ({rel})")
    perr = max(r0["param_max_abs_err"].values())
    check(perr <= TRAIN_PARAM_ATOL, f"dp 2 x tp 4 updated params within {TRAIN_PARAM_ATOL} of "
                                    f"one process ({r0['param_max_abs_err']})")
    pdir = tmp / "dryrun-product"
    write_product_dir(pdir)
    t0 = time.perf_counter()
    four = _spawn_ranks(4, tmp, [("dryrun_product", (str(pdir),))])
    four_s = time.perf_counter() - t0
    prod = four[0]["dryrun_product"]
    check(prod["tp4"] == prod["one"], f"dryrun product tp=4: {prod['tp4']!r} == {prod['one']!r}")
    print("dryrun phase: product tp=4 ok", flush=True)
    dr = eight[0]["dryrun"]
    check(dr["pp"] and dr["sp"], "dryrun: pp and sp ran")
    print(f"dryrun_multichip ok: mesh dp={dr['dp']} tp={dr['tp']}, loss={dr['loss']:.4f}, "
          f"pp=ok sp=ok product_tp=ok", flush=True)
    launches = [sum(r[job]["launches"][k] for group in (eight, four) for r in group
                    for job in r) for k in range(3)]
    check(launches == [0, 0, 0], f"the training ranks launched no kernel ({launches})")
    row = {"train": {
        "one_process": {"layers": cfg.num_layers, "batch": [TRAIN_B, TRAIN_S], "dtype": "f32",
                        "step_ms": step_ms, "peak_gb": peak_gb,
                        "loss": float(loss32), "loss_rel_err_vs_f64": loss_rel,
                        "grad_rel_err_max": max(grad_rel.values()),
                        "grad_rel_err_worst_leaf": max(grad_rel, key=grad_rel.get)},
        "dp2_tp4": {"layers": 2, "loss": r0["loss"], "loss_rel_err": rel,
                    "param_max_abs_err": perr, "step_s": [r["train"]["step_s"] for r in eight],
                    "rank0_bytes": r0["bytes"], "transport": r0["transport"],
                    "ranks_s": eight_s},
        "dryrun": {"loss": dr["loss"], "product_text": prod["tp4"], "product_ranks_s": four_s},
        "job_s": _job_seconds(eight, four),
        "measured_as": "ranks sharing one card over gloo staged through host memory, "
                       "not a scale-out number"}}
    print(json.dumps(row))
    return row

# ---------------------------------------------------------------------------
# phase 19: the model zoo's decoders and whisper-large-v3
# ---------------------------------------------------------------------------

ZOO_FAULTS = ("kv_heads_rolled", "qkv_bias_dropped", "longrope_long_factors")


@contextlib.contextmanager
def zoo_fault(lm, name: str):
    """Within the block one ZOO_FAULTS fault is planted in decoder lm's
    forward: its flash calls given k and v rolled by one KV head (each group
    of query heads attends another group's K/V: a wrong head map in the
    kernel's fold), Qwen2's q/k/v biases dropped, or Phi-3's rope tables
    built with the long factors where the cache's length (the original
    window, 4,096) takes the short ones."""
    import torch
    from kjarni_tpu_torch.models import llama as kllama
    saved = kllama.flash_attention, lm.params
    if name == "kv_heads_rolled":
        real = kllama.flash_attention
        kllama.flash_attention = lambda q, k, v, **kw: real(q, k.roll(1, 1), v.roll(1, 1),
                                                            **kw)
    elif name == "qkv_bias_dropped":
        layers = {n: ({k: t for k, t in e.items() if k != "b"} if n in ("q", "k", "v") else e)
                  for n, e in lm.params["layers"].items()}
        check(all("b" in lm.params["layers"][n] for n in ("q", "k", "v")),
              "qkv_bias_dropped: the model has q/k/v biases")
        lm.params = {**lm.params, "layers": layers}
    else:
        cfg = lm.config
        check(cfg.longrope_long_factor is not None, "longrope_long_factors: a longrope model")
        swapped = dataclasses.replace(cfg, longrope_short_factor=cfg.longrope_long_factor)
        cos, sin = (torch.from_numpy(t).to(lm.device)
                    for t in kllama.rope_cache(swapped, lm.max_context))
        check(not torch.equal(cos, lm.params["rope_cos"]), "the long factors' tables differ")
        lm.params = {**lm.params, "rope_cos": cos, "rope_sin": sin}
    try:
        yield
    finally:
        kllama.flash_attention, lm.params = saved


def zoo_engine(lm, tag: str) -> dict:
    """One ContinuousEngine pass of 8 greedy requests in two bursts after a
    256-token system prompt, the admission gate at 1 byte so that every
    wave takes the flash plan (lanes at q_offset 256): flash launches, and
    every token within the tie band of a teacher-forced plain forward."""
    bos = len(lm.encode_prompt("w5")) - 1
    system = _prompt(SERVE_SYSTEM - bos, 100, lm.config.vocab_size)
    small = [[(200 + 100 * i, 8, False) for i in range(4)],
             [(150 + 120 * i, 8, False) for i in range(4)]]
    c0 = _counts()
    run = run_engine(lm, system, small, seed=500, capture=True, score_limit=1)
    flash_n, int4_n = (a - b for a, b in zip(_counts(), c0))
    waves = run["eng"].stats["admission_waves"]
    check(set(run["probe"].modes) == {"flash"} and flash_n == lm.config.num_layers * waves,
          f"{tag} engine: every wave on flash ({run['probe'].modes}), {flash_n} launches, "
          f"{lm.config.num_layers} per wave x {waves}")
    held = hold_engine_rows(lm, run)
    check(held["max_margin"] <= SERVE_TIE_BAND, f"{tag} engine: tokens within "
                                                f"{SERVE_TIE_BAND} ({held['max_margin']})")
    return {"requests": len(run["done"]), "admission_waves": waves, "seconds": run["seconds"],
            "tok_per_s": run["tok_per_s"], "flash_launches": flash_n,
            "int4_launches": int4_n, "max_margin": [held["max_margin"], SERVE_TIE_BAND],
            "min_cosine": held["min_cosine"], "tokens": held["tokens"]}


# the readings of a run_slice summary that phase 19's line per model keeps
ZOO_KEYS = ("load_s", "prefill_ms_1024", "stream_ttft_ms", "stream_decode_tok_per_s",
            "peak_mem_gb", "logits_cosine", "kernels_vs_f32_max_abs_err",
            "plain_bf16_vs_f32_max_abs_err", "logits_rel_err", "max_margin", "faults",
            "int4_max_err_share", "int4_min_cosine", "flash_launches", "int4_launches",
            "engine")


def run_zoo_family(name: str, src: str, c: dict, depth: int, tmp: Path, seed: int) -> dict:
    """Write one ZOO decoder's dir (full width, `depth` layers, random bf16
    weights from `seed`, a word-level tokenizer over its vocabulary), run it
    through run_slice in bf16 and int4 (Qwen2.5-0.5B also in f32 and through
    the engine), print its line and delete the dir."""
    import shutil
    d = tmp / name
    t0 = time.perf_counter()
    write_model_dir(d, seed, {**c, "num_hidden_layers": depth})
    write_tokenizer(d / "tokenizer.json", c["vocab_size"])
    H, Hkv, D = heads(c)
    row = {"zoo": name, "source": src, "layers": f"{depth} of {c['num_hidden_layers']}",
           "H": H, "Hkv": Hkv, "G": H // Hkv, "D": D, "write_s": time.perf_counter() - t0,
           "gb": (d / "model.safetensors").stat().st_size / 1e9}
    first = name == ZOO[0][0]
    faults = {ZOO[0][0]: ("kv_heads_rolled", "qkv_bias_dropped"),
              "phi3.5-mini": ("longrope_long_factors",)}.get(name, ())
    slices = {"bf16": dict(faults=faults, engine=first), "int4": dict(quantize="int4")}
    if first:
        slices["f32"] = dict(dtype="f32")
    for tag, kw in slices.items():
        got = run_slice(d, new_tokens=ZOO_NEW_TOKENS, profile=False, **kw)
        check(got["reuse_offset"] == zoo_reuse_offset(c), f"{name} {tag}: the follow-up "
              f"resumed at {got['reuse_offset']}, phase 2's q_offset {zoo_reuse_offset(c)}")
        row[tag] = {k: got[k] for k in ZOO_KEYS if k in got}
        # each logits check's reading beside its bound
        if tag == "f32":
            row[tag]["logits_rel_err"] = [got["logits_rel_err"], F32_LOGITS_REL]
        else:
            row[tag]["logits_cosine"] = [got["logits_cosine"], 0.995]
            row[tag]["kernels_vs_f32_max_abs_err"] = [got["kernels_vs_f32_max_abs_err"],
                                                      2 * got["plain_bf16_vs_f32_max_abs_err"]]
    shutil.rmtree(d)
    row["seconds"] = time.perf_counter() - t0
    print(json.dumps(row))
    return row


def zoo_whisper(tmp: Path) -> dict:
    """whisper-large-v3 (full width, the encoder's 32 layers, the decoder's
    first 4) through Transcriber on the card: the encoder on flash (32
    launches per encode) against the plain encoder under phase 11's bound
    (and its causal fault outside it), one 30 s transcribe with
    task="translate" whose prompt holds large-v3's own ids and whose tokens
    lie in the tie band of a teacher-forced forward, and one with
    language="auto" whose detected language is the argmax over all 100 of
    large-v3's language tokens."""
    import torch
    from kjarni_tpu_torch import Transcriber
    from kjarni_tpu_torch.audio.loader import write_wav
    from kjarni_tpu_torch.audio.mel import log_mel_spectrogram
    from kjarni_tpu_torch.models import whisper as kwhisper
    from kjarni_tpu_torch.models import whisper_transcriber as wt
    from kjarni_tpu_torch.ops.kernels.flash_attention import flash_attention
    c = {**WHISPER_LARGE_V3, "decoder_layers": WHISPER_LARGE_V3_DECODER_LAYERS}
    E = c["encoder_layers"]
    d = tmp / "whisper-large-v3"
    t0 = time.perf_counter()
    row = {"zoo": "whisper-large-v3", "source": "openai/whisper-large-v3",
           "layers": f"encoder {E} of {E}, decoder {WHISPER_LARGE_V3_DECODER_LAYERS} of "
                     f"{WHISPER_LARGE_V3['decoder_layers']}", "heads": c["encoder_attention_heads"],
           "D": c["d_model"] // c["encoder_attention_heads"]}
    stage = _stages(row)
    write_encdec_dir(d, c, seed=80)
    specials = whisper_specials(100)
    write_tokenizer(d / "tokenizer.json", c["vocab_size"], specials)
    a30 = _speech(30.0, 61)
    wav = tmp / "a30.wav"
    write_wav(wav, a30, 16000)
    stage("write")
    tr = Transcriber(str(d), task="translate")
    wm = tr._model
    check(wm.use_flash and wm.dtype == torch.bfloat16, "whisper-large-v3: bf16, flash")
    prompt = wm.build_prompt_tokens(tr.config)
    want = [specials[t] for t in ("<|startoftranscript|>", "<|en|>", "<|translate|>",
                                  "<|notimestamps|>")]
    check(prompt == want, f"whisper-large-v3 translate prompt {prompt}, expected {want}")
    encodes, real_encode = [0], kwhisper.encode

    def counted(*a, **kw):
        encodes[0] += 1
        return real_encode(*a, **kw)
    # the language="auto" Transcriber over the same loaded model
    auto = copy.copy(tr)
    auto.config = wt.WhisperTranscriberConfig(language="auto")
    detected, real_detect = [], wm.detect_language

    def detect(kv):
        detected.append(real_detect(kv))
        return detected[-1]
    wm.detect_language = detect
    stage("load")
    kwhisper.encode = counted
    torch.cuda.reset_peak_memory_stats()
    f0 = flash_attention.launches
    try:
        secs = {}
        for what, t in (("translate", tr), ("auto", auto)):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = t.transcribe_file(wav)
            torch.cuda.synchronize()
            secs[what] = time.perf_counter() - t1
            row[f"{what}_words"] = len(res.text.split())
    finally:
        kwhisper.encode, wm.detect_language = real_encode, real_detect
    launched = flash_attention.launches - f0
    check(launched == E * encodes[0] and encodes[0] >= 2,
          f"whisper-large-v3: {launched} flash launches, {E} per encode x {encodes[0]}")
    row.update(flash_launches=launched, encode_calls=encodes[0], transcribe_s=secs,
               rtf={k: 30.0 / v for k, v in secs.items()},
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    stage("main_path")
    main_counts = _counts()
    # the language detection: the argmax over large-v3's 100 language tokens
    chunk = wm.chunk_audio(a30)[0]
    with torch.inference_mode():
        ck, cv = wm._encode_chunk(wt.audio_pcm16(chunk))
        sk, sv = wm._new_cache(1, 8)
        lg = wm._logits(wm._prompt_ids([specials["<|startoftranscript|>"]]), sk, sv, ck, cv,
                        0)[0].float()
    langs = {t: i for t, i in specials.items() if 50259 <= i < specials["<|translate|>"]}
    best = max(langs, key=lambda t: lg[langs[t]].item())
    check(len(langs) == 100 and detected == [best.strip("<|>")],
          f"whisper-large-v3: detected {detected}, the argmax over 100 languages {best}")
    row["detected_language"] = detected[0]
    stage("detection")
    # the encoder on flash against the plain one, and the causal fault
    pcm = torch.from_numpy(wt.audio_pcm16(chunk[None])).cuda()
    mel = log_mel_spectrogram(wt._dequant_pcm(pcm), wm.mel_config).to(wm.dtype)
    with torch.inference_mode():
        hf = kwhisper.encode(wm.params, wm.config, mel, use_flash=True)
        hp = kwhisper.encode(wm.params, wm.config, mel, use_flash=False)
        with whisper_fault(wm, "encoder_flash_causal"):
            hc = kwhisper.encode(wm.params, wm.config, mel, use_flash=True)
        cos, fault = (torch.nn.functional.cosine_similarity(h.float(), hp.float(), dim=-1)
                      .min().item() for h in (hf, hc))
        row["encoder_ms"] = {
            f"{'flash' if fl else 'plain'}": cuda_ms(
                lambda fl=fl: kwhisper.encode(wm.params, wm.config, mel, use_flash=fl),
                iters=3) for fl in (True, False)}
    check(cos >= WHISPER_FLASH_COS_MIN and fault < WHISPER_FLASH_COS_MIN,
          f"whisper-large-v3: encoder flash vs plain cosine {cos} >= {WHISPER_FLASH_COS_MIN}, "
          f"the causal fault {fault} below")
    row["encoder_flash_vs_plain_min_cosine"] = [cos, WHISPER_FLASH_COS_MIN]
    row["fault_encoder_flash_causal"] = fault
    stage("encoder")
    # the translate request's tokens against a teacher-forced forward
    cfg = tr.config
    cache_len, max_steps, allow = wm._plan(prompt, cfg)
    ids, _ = wm._decode_loop(prompt, ck, cv, allow, cache_len, 0.0, None, max_steps)
    margins = _wave_margins(wm, [chunk], [ids], prompt, allow)
    check(max(margins) <= WHISPER_TIE_BAND, f"whisper-large-v3: translate tokens within "
                                            f"{WHISPER_TIE_BAND} ({max(margins)})")
    row["max_margin"] = [max(margins), WHISPER_TIE_BAND]
    row["tokens"] = len(ids)
    stage("tie_band")
    _restore(main_counts)
    del tr, auto, wm, ck, cv, hf, hp, hc, mel
    gc.collect()
    torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t0
    print(json.dumps(row))
    return row


def phase_zoo() -> dict:
    """Phase 19 (see the module docstring): the ZOO decoders in turn, then
    whisper-large-v3; every planted fault must have read outside its bound."""
    rows = {}
    with tempfile.TemporaryDirectory(prefix="kjarni_zoo_") as tmp:
        for i, (name, src, c, depth) in enumerate(ZOO):
            rows[name] = run_zoo_family(name, src, c, depth, Path(tmp), seed=200 + i)
        rows["whisper-large-v3"] = zoo_whisper(Path(tmp))
    planted = {f for r in rows.values() for f in r.get("bf16", {}).get("faults", {})}
    check(planted == set(ZOO_FAULTS), f"every zoo fault planted ({sorted(planted)})")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(["env", "kernels", *GENERATION, *ENC_DEC,
                                                  "embed", "search", "zoo"]))
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the checkout whose kjarni_tpu_torch is imported")
    args = ap.parse_args()
    phases = args.phases.split(",")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    from kjarni_tpu_torch.ops.kernels.flash_attention import flash_attention
    from kjarni_tpu_torch.ops.kernels.int4_matvec import int4_matvec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_env()   # builds the kernels; every later phase needs them
    print(json.dumps({"phase": "env", "seconds": time.perf_counter() - t_start}))
    t0 = time.perf_counter()
    kern = phase_kernels() if "kernels" in phases else None
    if "flash" in phases and kern is None:
        phase_flash()
        phase_flash_f32()
    print(json.dumps({"phase": "kernels", "seconds": time.perf_counter() - t0}))
    _restore((0, 0, 0))
    if set(GENERATION) & set(phases):
        phase_slices(phases)
    for name, phase in (("seq2seq", phase_seq2seq), ("whisper", phase_whisper)):
        if name in phases:
            before = _counts()
            _counted(name, phase)
            check(_counts()[1] == before[1], f"the {name} phase launched no int4")
    if "embed" in phases:
        _counted("embed", phase_embed)
    if "search" in phases:
        _counted("search", phase_search)
    if "zoo" in phases:
        _counted("zoo", phase_zoo)
    launches = dict(zip(("flash", "int4", "flash_f32"), _all_counts()))
    if {"bf16", "int4", "int8", "chat", "serve", "infra", "whisper", "surfaces",
            "parallel", "zoo"} & set(phases):
        check(launches["flash"] > 0, "the main path launched the flash kernel")
    if {"int4", "batch", "serve", "infra", "f32", "surfaces", "parallel", "zoo"} & set(phases):
        check(launches["int4"] > 0, "the main path launched the int4 kernel")
    if {"f32", "zoo"} & set(phases):
        check(launches["flash_f32"] > 0, "the main path launched the f32 flash kernel")
    if kern is not None:
        f0, tok = kern["flash"][0], kern["int4_token"]
        line = {"kernels": [
            {"name": "flash_attention", "route": "cuda",
             "source": "kjarni_tpu_torch/csrc/flash_attention.cu",
             "replaces": "kjarni_tpu/ops/pallas/flash_attention.py:135",
             "launches": launches["flash"],
             "max_abs_err": max(r["max_abs_err"] for r in kern["flash"]),
             "ms": f0["kernel_ms"], "plain_ms": f0["plain_ms"],
             "bound_ms": f0["bound_ms"], "bound_by": f0["bound_by"],
             "library_ms": f0["library_ms"]},
            {"name": "int4_matvec", "route": "cuda",
             "source": "kjarni_tpu_torch/csrc/int4_matvec.cu",
             "replaces": "kjarni_tpu/ops/pallas/int4_matvec.py:70",
             "launches": launches["int4"],
             "max_abs_err": max(r["max_abs_err"] for r in kern["int4"]),
             "ms": tok["kernel_ms"], "plain_ms": tok["plain_ms"],
             "bound_ms": tok["bound_ms"], "bound_by": tok["bound_by"],
             "library_ms": tok["library_ms"],
             "f32_out_max_abs_err": max(r["max_abs_err"] for r in kern["int4_f32"]["rows"]),
             "f32_out_err_over_tol": max(r["max_abs_err"] / r["f32_tol"]
                                         for r in kern["int4_f32"]["rows"]),
             "f32_out_control_over_tol": min(r["bf16_store_control_err"] / r["f32_tol"]
                                             for r in kern["int4_f32"]["rows"]),
             "f32_out_ms": kern["int4_f32"]["token"]["kernel_ms"],
             "f32_x_removed_ms": kern["int4_f32"]["token"].get("removed_ms"),
             "f32_x_removed_eager_ms": kern["int4_f32"]["token"].get("removed_eager_ms")},
        ]}
        if kern["flash_f32"]:   # not in an older checkout (--root)
            f32 = kern["flash_f32"][0]
            line["kernels"].append({
                "name": "flash_attention_f32", "route": "cuda",
                "source": "kjarni_tpu_torch/csrc/flash_attention_f32.cu",
                "replaces": "kjarni_tpu/ops/pallas/flash_attention.py:135",
                "launches": launches["flash_f32"],
                "max_abs_err": max(r["max_abs_err"] for r in kern["flash_f32"]),
                "ms": f32["kernel_ms"], "plain_ms": f32["plain_ms"],
                "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
                "library_ms": f32["library_ms"],
                "bound_ms_ffma": f32.get("bound_ms_ffma"),
                "tf32_only_control_over_tol": min(
                    (r["control_max_abs_err"].get("TF32 only", math.inf) / r["bound"]
                     for r in kern["flash_f32"]), default=None)})
        print(json.dumps(line))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
