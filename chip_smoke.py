#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dynamo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

  1. device  -- the card's name, count and power limit (nvidia-smi);
  2. build   -- every CUDA kernel of the serving path, built from
                dynamo_tpu_torch/csrc/ with nvcc for sm_90a, all at once;
  2b. prebake -- tools/prebake.py (--model-path, --device cuda) on a
                Llama-3.1-8B-width directory at 16 layers with serve's
                shapes (max_batch 8, every bucket to 4096, H 4, spec_k 3)
                against this script's kernel directory: every library a
                cache hit, nvcc run 0 times, the decode graphs captured and
                listed in the manifest, the tool's wall time;
  3. parity  -- each kernel against its plain PyTorch version on the card,
                at Llama-3.1-8B shapes (Hq 32, Hkv 8, D 128, block 16,
                hidden 4096), with the window / scale / softcap variants,
                a ragged prompt, GQA groups 1 and 8, verify lanes whose
                drafts stop early, and a bias case; then #1-#4 at Qwen2-7B
                heads (Hq 28, Hkv 4: G 7) and Gemma-2-9B heads (Hq 16,
                Hkv 8, D 256), hidden 3584;
  3b. parity_tp -- #5's partial_out mode (the tensor-parallel o-projection:
                the raw f32 partial, no scale, no residual) against its plain
                version, bf16 weights and int8 mantissas, at per-rank shapes:
                Llama-3.1-8B tp=2 ([M, 2048] @ [2048, 4096]), one ring chunk of
                it (N 2048, a strided column slice) and Llama-3.1-70B tp=8
                ([M, 1024] @ [1024, 8192]), M = 8 and 32, at PARTIAL_TOL; the
                times phase times both modes at those shapes beside their bound
                and a cuBLAS yardstick (and #2 on one rank's heads of
                Llama-3.1-8B tp=2). Meanwhile, on two gloo ranks of cuda:0 of
                their own: ring attention, both expert-parallel forms (kernel
                g on each rank's experts) and prefill_pp / decode_pp against
                their one-device versions (``parallel_parity``).
  4. serve   -- TorchEngine built by build_torch_engine at the full width of
                Llama-3.1-8B (random bf16 weights from a seed), fused decode
                and spec decode off, 8 concurrent generate() calls, one of
                them with frequency / presence / repetition penalties and
                min_tokens; checks the outputs (that request: at least
                min_tokens tokens) and that the kernels' launch counters
                equal L x prefills and L x decode steps (the other
                three: 0);
  5. serve_spec -- the same weights behind an engine with fused_decode and
                spec_k=3, on repeating traffic; checks the outputs, >= 4
                verify dispatches, the launch counters (verify L x verify
                dispatches, the fused heads L x every decode and verify
                step, decode L x plain steps, prefill L x prefills), a
                dense reference and that the seeded request repeats;
  6. serve_default -- the default admission path on the serve phase's
                weights: build_torch_engine with its defaults (chunk 512,
                mixed steps on; fused and spec off), the serve phase's 8
                requests twice; short prompts are packed, long ones chunked
                inside the decode batch's mixed steps; checks mixed steps
                and packed prefills > 0, launches (decode L x (decode +
                mixed steps), the other four 0), a repeat-identical run and
                the dense reference on the shortest and the longest
                (chunked) prompt;
  6b. serve_mm -- multimodal serving on the serve phase's weights: an
                encode worker in process with a tower of CLIP ViT-L/14-336's
                shape (576 patches, hidden 1024, 24 layers; seeded weights),
                MultimodalEngine over a TorchEngine (EAGER, max_model_len
                8192) on the device path: four image chats (PNG data URLs
                this script writes, read by the port's stdlib reader) and an
                8-frame clip (an animated PNG) at once, 64 text tokens each;
                checks #3 = L x mm prefills (one per request) and #1 = L x
                decode steps, no Stored KV event from an mm sequence, the
                same image's greedy tokens equal on the device path and the
                wire path (an encode worker behind an in-process fabric), one
                request's prefill_mm logits within MM_TOL of the row max of
                the same spliced embeddings through the plain attention op,
                text-only logits apart from them, the same image encoded
                twice bitwise equal; prints the tower's encode, prefill_mm
                and image TTFT times. Then graphs/multimodal.py over HTTP
                (the fabric, the encode worker with the full-size tower, a
                worker at full width and CKPT_LAYERS depth, the frontend):
                one streamed image chat;
  7. checkpoint -- a 2-layer, full-width bf16 Llama-3.1-8B checkpoint
                written by this script's own safetensors writer, loaded by
                build_torch_engine(<dir>): the loaded weights equal the
                written ones bit for bit, and its greedy tokens equal an
                engine's built from the same arrays through params=; then a
                2-layer, full-width .gguf (this script's own writer: F16
                embeddings, output and MLP, F32 norms, Q8_0 attention, llama
                SentencePiece tokenizer metadata) in an HF-cache-shaped
                directory, resolved by repo id through DYN_MODEL_CACHE and
                loaded by build_torch_engine: its weights equal the script's
                own dequantization in bf16 bit for bit, its card serves the
                embedded tokenizer, its greedy tokens equal params='s;
  8. times   -- each kernel, its plain version and the PyTorch yardstick
                timed with CUDA events, beside the kernel's bound (and the
                kernel / yardstick ratio where the yardstick is one call),
                #1-#3 also at the Qwen2-7B and Gemma-2-9B head shapes;
                engine TTFT with the 2000-token prefill's device time, the
                B=8 decode step with the fused heads off and on (wall and
                device time, #1's time per launch and #4's per layer),
                tokens/s with spec off and on.

  9. serve_int8 -- the JAX package's int8 deployment: build_torch_engine(
                quantize=True, kv_dtype="int8", fused_decode=True) at full
                width (seed 0: the serve phase's bf16 draws, quantized) on
                the default admission path, the serve phase's 8 requests;
                then an engine over the same weights built from the JAX
                factory's variables (DYN_JAX_QUANTIZE_INT8=1,
                DYN_KV_DTYPE=int8, DYN_FUSED_DECODE=1, DYN_SPEC_K=3) over
                quoting traffic. Checks the outputs, the launch counters
                (the four int8 modes' and no bf16 kernel's), the dense
                reference over the same int8 weights (it attends the
                unquantized K/V: gap bound INT8_REF_GAP) and the int8
                sizing; the parity phase also holds the four int8 modes to
                their plain versions (Llama-3.1-8B, Qwen2-7B and Gemma-2-9B
                heads, window and softcap, pages with their own scales,
                M = 8 and 32), and the times phase times each int8 mode,
                the int8 B=8 fused step and 2000-token TTFT beside bf16's,
                and the unfused int8 products' share of the step.

 10. serve_http -- `python -m dynamo_tpu_torch.run in=http out=torch` in
                its own process (this process's engines freed first) over a
                model directory written under build/serve_http/: the
                published Llama-3.1-8B config.json (no weights: 32 layers of
                seeded random bf16), a Llama-3-shaped byte-level BPE
                tokenizer.json of 128256 ids made by this script, and a
                Llama-3 chat template. Driven with stdlib http.client: one
                lone greedy request (TTFT, ITL), 8 concurrent streamed chat
                completions (prompts of ~16-2000 tokens, one with a stop
                string, one with penalties and min_tokens; each stream's
                form, finish reason and usage checked against the tokens
                streamed), one non-streamed completion, one stream closed
                after 4 chunks and a request after it (its lane must be
                freed: the server's exit stats). Then the lone request
                through an in-process build_torch_engine(<dir>) and the
                port's preprocessor and backend: the text must equal the
                HTTP text. The lone request's timing: 3 pairs in turns
                through HTTP and engine-direct in a process of its own
                alive beside the server (started as the server's is),
                medians and the per-pair difference. Also the host time
                of templating + tokenizing a 2000-token prompt. On the same
                server: POST /v1/embeddings with two inputs (4096 finite
                floats each, different, ``usage``; within MM_TOL of the plain
                op's embed_pooled over the same weights; the server's #3
                launches = L x 2, all of them the embeddings'), GET
                /debug/profile?seconds=1 while a request streams (200, then
                409; the window's trace holds kernel events and dispatch
                labels), and an image part answered 501 (a text-only model).

 11. serve_tp -- tensor-parallel serving on one card (before serve_http):
                build_torch_engine(tensor_parallel_size=2, tp_backend="gloo",
                tp_devices=["cuda:0", "cuda:0"], fused_decode=True) at full
                width and 4 of the 32 layers (TP_MODEL), bf16 then int8
                weights + int8 KV, each beside a one-card engine on the same
                seeded weights: the first decode step's logits within
                TP_LOGIT_TOL of the one-card engine's, four of serve's
                requests served to the end, every rank's #1, #4 and 5p (5pq)
                launched layers x fused steps (summed over both ranks' counters,
                the followers' read back through the step channel), the share of
                greedy tokens that agree with one card, the B=8 step's time on
                both, its collective share and each rank's peak memory; then a
                one-rank NCCL group runs a fused step with
                DYN_COLLECTIVE_OVERLAP=1 (the ring with zero hops). Between
                them, disaggregation and tiers under the group: a tp = 1
                engine ships serve's two longest prompts to a tp = 2 group
                (HostPrefillClient, streamed and monolithic, 16 tokens out),
                the group ships the longest to the tp = 1 engine, then the
                group (DYN_KV_HOST_OFFLOAD_GB=4) onboards a 1024-token prefix
                its first request offloaded; every landing and onboarded page
                bitwise on each rank (the group's gather, and the leader's own
                head slice), every stream within 0.25 of the dense reference.
                Two ranks on one card over gloo check correctness and say
                nothing of collective speed across cards. On the bf16 leg's
                engines also an image's prefill_mm logits (OP_MM_PREFILL)
                and a pooled embedding (OP_EMBED) within TP_LOGIT_TOL of one
                card's, #3 2 x L a rank. The parallel legs
                (PR 21): on the bf16 leg's engines, spec decode under the
                group -- the verify pass's logits (``verify_logits``) within
                TP_LOGIT_TOL of one card's, then eight greedy prompts served
                by the group at H 4 with spec off and with spec_k 3, the
                spec engine drafting each lane's spec-off continuation, so
                drafts are accepted and every verify chains 3 steps over
                OP_VERIFY (each rank's #2 once a layer per verify dispatch;
                spec on equals spec off up to a near-tie of the dense
                reference); then the CP leg: a
                fabric server, this process as node 0 and ``chip_smoke.py
                --cp-node`` as node 1 (DYN_NUM_NODES=2) meet through the
                multi-node rendezvous into an sp = 2 grid on cuda:0 over gloo,
                whose ring prefill of a CP_PROMPT-token prompt and the decode
                step after it give logits within TP_LOGIT_TOL of the one-card
                engine's #3 prefill (each rank's #3 at 0), and the prompt is
                served; logs build/serve_http/cp_*.log. ``--only serve_tp``
                runs the build and this phase alone.

 12. serve_horizon -- the decode horizon on CUDA graphs, build_torch_engine's
                defaults on a card (H = 4; the decode step, the horizon and
                the verify pass captured once per key, replayed per dispatch)
                over the serve phase's weights: serve's 8 requests twice, then
                eight "lockstep" requests that one packed prefill admits;
                every launch of a graphed run must equal replays x the
                launches its graph's capture recorded, #1 = L x step bodies
                (frozen steps included), no lazy-horizon degrade; the same
                runner eagerly at H = 4 must stream the same tokens on serve's
                traffic, and eagerly at H = 1 the same on the lockstep
                requests (on serve's traffic lanes join at other steps, which
                changes the paged kernels' split sizes: the share of equal
                tokens is reported); the same for the int8 deployment
                (serve_int8's runner: int8 weights and cache, fused heads);
                each graph (decode H 1, decode_multi H 4, verify S 4 with
                E 3) replayed against the same call made eagerly on the same
                cache contents, bitwise, in both cache forms; then serve
                tokens/s eager H 1 / graphed H 1 / graphed H 4 (one run each), spec
                tokens/s with E 0 and E 3, and the B=8 step eager against
                graphed (wall, device, host), fused and unfused, bf16 and
                int8; each graph key's capture seconds and the memory the
                graphs hold.

 13. serve_moe -- Mixtral-8x7B (its published config.json) at 16 of its 32
                layers (all 32 hold 93.4 GB of bf16, more than the card's 80;
                random weights from seed 0) through build_torch_engine's
                defaults: H = 4 on CUDA graphs, chunk 512, mixed steps. The
                grouped SwiGLU FFN kernel (csrc/grouped_swiglu_ffn.cu) against
                its plain version at Mixtral's width on layer 0's experts (R 2,
                16, 64 and 1024 rows, every row on one expert, empty experts)
                at GEMV_TOL, and moe_ffn_dropless against an f32 per-token
                oracle at the B=8 step's shape; serve's 8 requests (ids below
                32000) twice: outputs, repeat-identical, launches = replays x
                captured (+ the grouped kernel once per layer of each eager
                packed prefill and chunk), the grouped kernel once per layer
                and step body, the dense reference on one stream (bound
                MOE_REF_GAP); every graph's replay bitwise its eager call; then
                the graphed step at B = 8 and 1 (wall, device, the grouped
                kernel's and the MoE layers' share) and the kernel at the
                step's routing and a chunk's beside its bound (the routed
                experts' bytes), its plain version and torch._grouped_mm; then
                the EP leg (PR 21): EP_LAYERS layers at the same width on one
                card, then an ep = 2 grid (two gloo ranks on cuda:0, 4
                experts each): the decode step's logits after a packed
                prefill (the all-to-all form, then the psum form) within
                TP_LOGIT_TOL of one card's, four of serve's requests served,
                kernel g launched on every rank. Runs after serve_tp, before
                serve_http; ``--only serve_moe`` runs the build and this
                phase alone.

 14. serve_disagg -- disaggregated prefill/decode on this card (after
                serve_horizon): a decode engine and a prefill engine, both from
                build_torch_engine's defaults (H = 4 on CUDA graphs, chunk 512,
                2112 blocks) sharing serve's bf16 weights, the decode engine's
                router at the reference's DisaggConfig() (prompts over 50 tokens
                ship); serve's 8 requests through four legs, each leg's counters
                set to 0 just before it, read just after: (a) the device path
                (ColocatedPrefillClient: prefill_only_device, blocks moved card to
                card, twice), (c) the host payload, monolithic (prefill_only
                through HostPrefillClient, every payload through its wire dict),
                (d) the host payload streamed (prefill_only_stream's frames into
                the decode engine's on_frame), and (b) the device path between
                two int8 engines (serve_int8's int8 weights, int8 KV: #1q, twice).
                Checks per leg: the outputs, remote prefills = the 7 prompts over
                50 tokens with no local fallback and no local prefill of a shipped
                prompt, #3 launched L x the prompts the prefill engine prefilled
                single-shot, every other launch a decode graph's replay, every
                landing's blocks against the blocks the prefill engine wrote for
                the same prompt (LandingProbe: bitwise; int8 quantized again on
                landing: within a quantization step), every block of every
                shipped prompt compared, one landing per prompt plus one per
                streamed frame, each streamed prompt landed through frames, the
                decode cache's addresses unchanged, the payload bytes and
                frames landed = shipped on the host legs and none on the device
                path (the monolithic leg runs under DYN_KV_STREAM=0), and the
                dense reference on every greedy stream (bf16 0.25, int8
                INT8_REF_GAP). Then the yardsticks in the same run, once each:
                the decode engine serving alone (chunks) and an engine from the
                defaults with prefill_chunk_tokens=0 (#3 single-shot on its own
                thread). Times: tokens/s, the inter-token gap (p50 / p99 / max
                over every gap of every request) and peak memory per leg; the
                2000-token TTFT disaggregated, local through chunks and local
                single-shot, in turns, with each one's device time; the extract
                and the inject of its 125 blocks beside their byte bound and
                index_select / index_copy_; the host payload's device-to-host /
                encode / checksum / decode / host-to-device split.

 15. serve_offload -- the tiered block manager (after serve_disagg):
                build_torch_engine's defaults (H = 4 on graphs, chunk 512) on
                serve's bf16 weights with DYN_KV_HOST_OFFLOAD_GB=4 (2048
                pinned host blocks of 2 MiB). (a) Wave 1: 8 requests of one
                1024-token prefix (64 blocks) + distinct 64-448-token
                suffixes, 32 out; wave 2: 8 new suffixes, each onboarding
                the 64 blocks, every onboarded block bitwise the page stored
                under its hash (OnboardProbe); the 1280-token TTFT miss
                against hit in turns (wall, device); the tier's store / load
                of 64 blocks and the pinned / pageable copies beside the PCIe
                bound. (b) A 1024-token request still decoding is
                prefix-hit by a later one. (c) 99 usable blocks for three
                lanes: preemptions resumed by onboarding, with the
                mid-generation drain and without it (the spill path). (d)
                int8 weights, an int8-resident cache and fused decode: int8
                tiers, pages verbatim both ways. (e) A 16-block host tier
                over DYN_KV_DISK_DIR under build/: spills and promotions. (f)
                serve_disagg's colocated pair with the tier on the decode
                engine: a shipped prompt with a cached prefix sends
                cached_blocks 64 and gets the rest. (g) POST /clear_kv_blocks
                through the HTTP server (a later lookup misses), then a
                decode dispatch patched to sleep 3 s past a 0.5 s warm budget
                trips the watchdog (watchdog_stuck, then worker_unavailable);
                every label's first dispatch under the 300 s cold budget.
                Every leg: no offload or onboard exception, no local
                fallback, no checksum failure; KV events counted, each hash
                recomputed on the CPU from its tokens; the dense reference on
                the greedy streams. ``python3 chip_smoke.py --only
                serve_offload`` runs the build and this phase alone.
 16. serve_fabric -- the port as a distributed deployment (last, after
                serve_http, whose model directory it serves): the port's
                fabric server, two ``run in=dyn://dynamo.backend.generate
                out=torch`` workers at Llama-3.1-8B width (random weights,
                ``--num-blocks 2048`` each, the defaults otherwise: H = 4
                on graphs) and a ``run in=http out=dyn`` frontend (round
                robin), all processes on cuda:0, beside an engine-direct
                process. The lone greedy request through the fabric and
                engine-direct, 3 times each in turns (TTFT, ITL; every text
                equal, and equal to serve_http's); serve_http's 8
                concurrent streams and a non-streamed completion; each
                worker's stats (SIGUSR1): both served, #1 launched in both.
                The codec's microseconds per token frame (encode + decode).
                Migration: SIGKILL the worker serving a 256-token greedy
                stream; the stream completes with no token dropped or
                repeated (the prefix up to the kill equal to the unfaulted
                run, 256 tokens) and the share of the tail that agrees is
                printed; the killed instance leaves discovery within the
                lease TTL (plus the janitor's 0.5 s pass and the 0.25 s
                of this script's poll); the next 4
                requests land on the survivor; SIGTERM drains the survivor
                (its stream in flight finishes, it leaves discovery at once,
                exits 0 with every lane and block free); the frontend counts
                the migration. ``python3 chip_smoke.py --only serve_fabric``
                runs the build and this phase alone.
 17. serve_kv -- KV-aware routing (last): the fabric server, two ``run
                in=dyn://dynamo.backend.generate out=torch`` workers at
                Llama-3.1-8B width (``--num-blocks 2048``,
                ``DYN_KV_HOST_OFFLOAD_GB=4``, the defaults otherwise: H = 4 on
                graphs), a ``run in=http out=dyn --router-mode kv
                --router-temperature 0`` frontend, a round-robin frontend over
                the same workers (driven only in turns with the kv one) and
                ``python -m dynamo_tpu_torch.router``, all on cuda:0. Traffic:
                4 groups a mode, each a fresh 1024-token prefix (64 blocks) and
                4 suffixes of 64-256 tokens, 128 greedy tokens out, the leader
                first and, once its first token is back, its 3 followers 0.3 s
                apart while it decodes (the frontends' and the router's
                health planes score without deweighting or ejecting:
                ``KV_HEALTH_ENV``; after the warm-up each worker's health
                score from both frontends must be under the default eject
                ratio 3.0: a capturing dispatch's gaps stay out of
                ``inter_token`` and the scorer's ``pace``, C15); the
                worker that admitted each request (its id in the workers'
                SIGUSR1 stats) and the prefix blocks its tier held. Prints the
                share of followers on their leader's worker, follower TTFT
                (median, max) and each worker's onboarded blocks per mode;
                checks both workers served and launched #1 in that traffic
                (the warm-up's launches subtracted), at least 11 of kv's 12
                followers on their leader's worker, the kv frontend's router
                matching cached blocks, no tier error or checksum failure,
                the standalone router's find_best (asked
                while kv's first group runs) naming the leader's worker and its
                free answering, its index empty once every stream ended, and
                every stream's first 8 tokens against the dense reference (the
                workers' seed-0 weights in this process once they are gone).
                Then the agg graph (``python -m dynamo_tpu_torch.serve
                dynamo_tpu_torch.graphs.agg``, tiny-torch workers on the card,
                kv, the default lease): a request, Worker-0 (started once)
                SIGKILLed and restarted by its supervisor, the next request,
                exit 0 on SIGTERM. ``python3
                chip_smoke.py --only serve_kv`` runs the build and this phase
                alone.
 18. serve_disagg_fabric -- disaggregation across processes (last): the
                port's fabric server and the disagg graph (``python -m
                dynamo_tpu_torch.serve dynamo_tpu_torch.graphs.disagg``,
                DYN_GRAPH_ENGINE=torch on serve_http's Llama-3.1-8B
                directory, DYN_MAX_LOCAL_PREFILL=50, DYN_HBM_GB=21 a worker so
                three 8B engines share the card, the defaults otherwise:
                H = 4 on graphs, chunk 512) under two supervisors: two
                PrefillWorkers and the frontend, and the DecodeWorker. (a)
                Streamed frames: serve_http's 8 requests; the workers' SIGUSR1
                stats read just before and just after must show 7 remote
                prefills (the prompts over 50 tokens) and no local fallback,
                #3 launched 32 x the shipped prompts of at most 512 tokens on
                the prefill workers (longer ones stream chunks), #1 on the
                decode worker only by graph replays, frames and bytes received
                equal to those sent, no integrity failure or fenced frame; the
                2000-token TTFT through the graph twice; the transport alone
                in turns (this process's RemotePrefillClient to the prefill
                workers, streamed and monolithic, every payload landed on the
                card); the host path of the 125-block payload (d2h, encode,
                checksum, pack, publish through the server, unpack, decode,
                h2d); a request hung up on while four 3000-token prompts hold
                the prefill workers: a prefill worker counts the cancelled
                stream, the decode worker frees every block. (b) A new
                DecodeWorker with DYN_KV_STREAM=0: the same 8 requests (#3 =
                32 x 7), the TTFT twice, a 256-block prompt (512 MiB of K/V,
                over the fabric's frame limit) answered too_large and prefilled
                locally at once, and the prefill worker holding a 2000-token
                prompt SIGKILLed: the queue redelivers it after 30 s
                (DYN_PREFILL_TIMEOUT_S=45) and the stream completes; whether
                the decode worker landed it or fell back is printed. Streams
                whose text differs from serve_http's, and the redelivered one,
                are held to the dense reference (first 8 tokens, 0.25).
                ``python3 chip_smoke.py --only serve_disagg_fabric`` runs the
                build and this phase alone.
  19. serve_trace_faults: request tracing and fault injection
                (``telemetry/trace.py``, ``testing/faults.py``). (a) The
                fabric server, an out=dyn frontend in kv mode and two
                in=dyn:// workers, every process with DYN_TRACE=1: serve_http's
                8 requests streamed at once, each with a traceparent; every
                request's ``GET /debug/traces/{request_id}`` must give one
                trace id over at least two process tracks, every parent inside
                the trace, the spans http_request, route, worker_generate,
                queue_wait and decode, and ``usage.timing`` on the final chunk;
                the medians of TTFT split by hop (edge to the route decision,
                to the worker, queue_wait, prefill, first frame back). (c) One
                worker drained and started again under
                DYN_FAULT=kill_after_tokens=40: four 128-token streams at once
                all complete with no error frame and no token lost after it
                kills itself, the frontend's exit stats count the migrations.
                (b) The disagg graph (one PrefillWorker with
                DYN_FAULT=corrupt_kv=bits,every=2, the DecodeWorker, the
                frontend; DYN_TRACE=1 everywhere, DYN_HBM_GB=21): the
                2000-token prompt and serve_http's 800- and 1600-token ones;
                every corrupted payload is refused by its checksum (the
                prefill worker's fired count equals the decode worker's
                integrity failures), those prompts are prefilled locally, and
                the 2000-token trace spans three process tracks (prefill_serve
                and kv_frame_tx on the prefill worker, remote_prefill on the
                decode worker), its split printed. The first 8 tokens of each
                migrated stream's replay (after its cut, read from the
                frontend's log), of the other streams and of the disagg ones
                are held to the dense reference (0.25). In this process, on
                build_torch_engine's defaults over the same weights:
                slow_decode=3 on the eager serve_default configuration (the
                same tokens, the ITL and the decode label's EMA stretched, the
                watchdog quiet), abort_after_tokens=50 over serve's 8 requests
                (every lane fails with injected_fault, every block free, the
                next request whole), and (d) tracing on against off, one turn
                each, on the graphed B=8 serve: tokens/s and the horizon step's
                EMA, their ratio (no bound). ``python3 chip_smoke.py --only
                serve_trace_faults`` runs the build and this phase alone.

  20. serve_peer -- the peer tier (G4-lite, block_manager/peer.py), run
                after serve_offload on the serve phase's weights: the
                port's fabric server as a child process and two engines from
                build_torch_engine's defaults (H = 4 on graphs, chunk 512,
                2112 blocks) with 4 GiB pinned host tiers, each engine on a
                DistributedRuntime of its own, so every pull crosses the TCP
                response plane; a PeerBlockService on A's tier, a
                PeerBlockClient on B's. (a) A serves a 1024-token prompt and
                offloads it; B serves it pulling from A (every onboarded
                page bitwise A's tier page, B's tier pages bitwise A's),
                with no client (recomputed) and from its own tier: the three
                TTFTs, the pull split (A's load_blocks, encode, send and
                receive, decode with verify, B's store_blocks), bytes and
                the onboard time. (b) The KV router's scheduler over an
                indexer fed by both engines' KV events, three 64-block
                requests counted on A: a follower of A's live prefix routed
                to B with a plan naming A, pull_stats.plans 1, the pull
                directed and `pulled`, the plan's fleet heat in B's tier.
                (c) corrupt_kv=bits on A's replies (the injector seen by
                the peer module alone): fallback_integrity, the stream equal
                to A's; DYN_KV_WIRE=int8: the bytes and the time; a
                3200-token prompt (200 blocks) against the 5 s pull
                timeout. (d) Four bulk and four interactive lanes in 63
                usable blocks: every preemption on bulk. (e) The native
                block hash loaded on this machine, microseconds per
                4096-token chain against Python, digests equal. Every
                stream within 0.25 of the dense reference (the int8 pull's
                INT8_REF_GAP). ``python3 chip_smoke.py --only serve_peer``
                runs the build and this phase alone.

  21. serve_ops (last) -- the frontend's operating plane across processes:
                the fabric server, two in=dyn:// workers at Llama-3.1-8B width
                (random bf16 weights from seed 0; DYN_RUNTIME_HTTP_ENABLED=1,
                so each serves /health, /live and /metrics), an out=dyn kv
                frontend (DYN_ADMISSION_MAX_INFLIGHT=6, DYN_TRACE=auto,
                DYN_LOGGING_JSONL=1) and the standalone router with
                --metrics-port. (a) The frontend's request, TTFT-count and
                inflight families equal the traffic sent, the workers'
                phase_histograms count their streams, the router's decisions
                counter its 3 decisions; each /metrics scrape's ms, and four
                streams' tokens/s with one scrape a second against none, in
                turns. (b) Three standard streams hold the slots, then a burst
                of 3 bulk, 2 standard and 1 interactive: every bulk request
                answered 429 (Retry-After 1-60 s), bulk shed first; the ms of
                a 429; every admitted stream held to the dense reference. (c) A
                second frontend whose TTFT objective (1 ms) nothing meets: its
                /debug/slo reads breached, its slo-status events step every
                ladder (the kv frontend's and both workers') rung by rung to 3
                (bulk shed at the kv frontend; spec paused; a 2000-token prompt
                prefilled in 8 chunks of 256 on the workers), then back to 0
                once its traffic stops, each transition's time after the breach
                event; DYN_TRACE=auto keeps the slow requests (slo_ttft) and an
                errored one (error:deadline_exceeded) and drops the fast ones.
                (d) One worker drained (its exit stats hold no lane or block)
                and started again with DYN_FAULT=slow_decode=3, warmed
                directly; six interactive 2000-token prompts through a
                round-robin frontend without hedging, then through one with
                DYN_HEDGE=1 (DYN_HEDGE_MIN_MS=350, DYN_HEDGE_BUDGET=1.0; both
                keep every worker in rotation): every hedged
                stream equals its unhedged twin, at least one hedge won; the
                TTFT p50 / p99 of both; a third round-robin frontend's scorer
                (DYN_EJECT_RATIO=2.0) ejects the gray worker, and at most 2 of
                the next 12 requests reach it (probes). (e) A tools request
                and /v1/responses answer 200; a JSONL with_fields line under a
                span carries the trace id. The workers' exit stats hold no
                lane or block; their kernel launches are printed.
                ``python3 chip_smoke.py --only serve_ops`` runs the build and
                this phase alone.

L is the layer count of the phase's model: Llama-3.1-8B's width at
MAIN_LAYERS (16) of its 32 layers in serve, serve_spec, serve_default,
serve_int8, times, serve_horizon and serve_disagg (and the fleet phases
below), every kernel at its full-width shapes; serve_offload, serve_peer,
serve_disagg_fabric and serve_ops run all 32, serve_tp 4 (TP_MODEL),
serve_trace_faults 8 (TF_MODEL), checkpoint 2.

Phases 4-6, 9 and 11 pin one eager step per dispatch (EAGER:
decode_horizon=1, cuda_graphs=False), the path they measured before the
horizon, so their launch equalities count one step a dispatch and their
times compare with earlier runs; checkpoint (7), serve_http (10),
serve_moe (13) and the workers of serve_fabric (16), serve_kv (17),
serve_disagg_fabric (18), serve_trace_faults (19) and serve_ops (21) run
build_torch_engine's defaults. serve_http, serve_fabric and serve_kv serve
FLEET_MODEL (Llama-3.1-8B's width at 16 of its 32 layers),
serve_trace_faults TF_MODEL (8); serve_disagg_fabric and serve_ops the
full 32.

Before its last lines the script stops every process the run left alive
(each one logged; SIGTERM, then SIGKILL) and waits until it is gone; a
process that survives fails the run. The line before the last is one JSON
object with a row per kernel; the last line is {"ok": true, "device":
{...}}. Needs torch, numpy and the checkout; imports nothing of JAX.
"""

from __future__ import annotations

import asyncio
import collections
import copy
import dataclasses
import gc
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (data sheet)
HQ, HKV, D, BLOCK = 32, 8, 128, 16  # Llama-3.1-8B attention shapes
MAX_MODEL_LEN = 4096
MAX_BLOCKS = MAX_MODEL_LEN // BLOCK  # block-table width at max_model_len
STEP_CTX = 1024  # the engine phase's B=8 decode step feeds position 1024

# Tolerances of kernel vs plain version (same bf16 inputs on the card; both
# accumulate in f32 and round the output to bf16).
#   decode: only the f32 summation order and exp/tanh differ, so outputs
#     differ by at most ~1 bf16 ulp: |d| <= 1e-3 + 2^-6 |plain|;
#   prefill: the kernel also rounds the softmax weights to bf16 for the
#     tensor-core P @ V product (relative 2^-9 per weight, |v| ~ 1 here):
#     |d| <= 1e-2 + 2^-6 |plain|.
#   verify: PR 2's kernel rounded the softmax weights to bf16 for P @ V, as
#     prefill does (the page-streaming kernel keeps them f32 in a bf16 hi/lo
#     pair and now also meets DECODE_TOL, which the card tests hold it to);
#   fused QKV / o-proj: the f32 products are summed in another order (split
#     contraction) and the norm's sum of squares too, so a bf16 rounding of
#     the normed activations or of the product may flip by one ulp before
#     RoPE / the residual add: a few bf16 ulps of the output,
#     |d| <= 1e-2 + 2^-6 |plain|.
DECODE_TOL = (1e-3, 2.0 ** -6)
PREFILL_TOL = (1e-2, 2.0 ** -6)
VERIFY_TOL = (1e-2, 2.0 ** -6)
GEMV_TOL = (1e-2, 2.0 ** -6)
HIDDEN = 4096  # Llama-3.1-8B hidden size
# other models' attention heads (Hq, Hkv, D) and hidden size, from their
# published config.json files: Qwen2-7B (a GQA group of 7) and Gemma-2-9B
# (head_dim 256)
HEAD_SHAPES = {"qwen2_7b": (28, 4, 128, 3584), "gemma2_9b": (16, 8, 256, 3584)}


# The paths of the phases before serve_horizon as they ran before the
# decode horizon: one eager step per dispatch (their launch equalities count
# one step a dispatch, and their times stay comparable with earlier runs).
# serve_horizon drives build_torch_engine's defaults (H = 4 on CUDA graphs)
# beside them; checkpoint and serve_http run the defaults too.
EAGER = dict(decode_horizon=1, cuda_graphs=False)


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- processes

# main() marks its environment with this run's id; every process the run
# starts inherits it, also one whose parent exited before it did
RUN_MARK = "CHIP_SMOKE_RUN"


def run_processes() -> dict:
    """{pid: command line} of every live process of this run but this one:
    the descendants of this process and every process that carries the
    run's mark in its environment. Zombies are left out: they hold nothing,
    and this process's own are reaped by stop_run_processes."""
    me = os.getpid()
    tag = os.environ.get(RUN_MARK)
    mark = f"{RUN_MARK}={tag}".encode() if tag else None
    parent, found = {}, set()
    for d in os.listdir("/proc"):
        if not d.isdigit() or int(d) == me:
            continue
        pid = int(d)
        try:
            with open(f"/proc/{pid}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            if state in ("Z", "X"):
                continue
            parent[pid] = int(ppid)
            if mark is not None:
                with open(f"/proc/{pid}/environ", "rb") as f:
                    if mark in f.read().split(b"\0"):
                        found.add(pid)
        except (OSError, ValueError):
            continue
    grown = True
    while grown:
        grown = False
        for pid, ppid in parent.items():
            if pid not in found and (ppid == me or ppid in found):
                found.add(pid)
                grown = True
    out = {}
    for pid in found:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                out[pid] = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            continue
    return out


def reap_children() -> None:
    """Collects the exit status of every child of this process that ended."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def stop_run_processes(grace_s: float = 15.0) -> dict:
    """Stops every process this run left alive and waits until each is gone:
    multiprocessing's resource tracker through its own shutdown, the rest
    by SIGTERM and, ``grace_s`` later, SIGKILL (a process leaving the card
    may take seconds). Logs each one it stops; returns those still alive,
    which fail the run."""
    import signal

    gc.collect()
    rt = sys.modules.get("multiprocessing.resource_tracker")
    tracker = getattr(rt, "_resource_tracker", None)
    if tracker is not None and hasattr(tracker, "_stop"):
        pid = getattr(tracker, "_pid", None)
        tracker._stop()  # closes its pipe; it exits and is waited for
        if pid is not None:
            log(f"stopped multiprocessing's resource tracker (pid {pid})")
    left = run_processes()
    if left:
        log(f"stopping {len(left)} process(es) this run left alive: "
            + "; ".join(f"pid {p}: {c[:200]}" for p, c in sorted(left.items())))
    for sig, wait_s in ((signal.SIGTERM, grace_s), (signal.SIGKILL, 30.0)):
        if not left:
            break
        for pid in left:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        t0 = time.perf_counter()
        while left and time.perf_counter() - t0 < wait_s:
            time.sleep(0.1)
            reap_children()
            left = run_processes()
    reap_children()
    return left


def finish_run(lines: list) -> int:
    """Stops what the run left alive; prints ``lines`` (the run's last
    lines) and returns 0, or fails the run if a process survived."""
    left = stop_run_processes()
    if left:
        print(f"[chip_smoke] FAIL: processes of this run survived SIGKILL: {left}",
              file=sys.stderr)
        return 1
    for line in lines:
        print(line, flush=True)
    return 0


# ------------------------------------------------------------------ timing


HOLD_CYCLES = 2_000_000  # ~1 ms of an idle spin kernel at the H100's clocks


def stats_dict(stats) -> dict:
    """A snapshot of an engine's stats as JSON: the phase histograms as their
    wire dict."""
    return copy.deepcopy({k: v.to_dict() if hasattr(v, "to_dict") else v
                          for k, v in vars(stats).items()})


def time_ms(torch, fn, reps: int = 20, warmup: int = 3, flush=None) -> dict:
    """Per-call CUDA-event times of fn() in ms: median and spread over
    `reps` calls. `flush` (if given) runs before every call, outside the
    timed region, to evict the L2 cache the way other layers would. A spin
    kernel that touches no memory holds the stream before the start event
    until fn() has been enqueued, so the time is the device's alone and not
    the host's work to launch it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {
        "median": statistics.median(times),
        "min": min(times),
        "max": max(times),
        "reps": reps,
    }


def make_flush(torch):
    buf = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def flush():
        buf.zero_()

    return flush


# ------------------------------------------------------------------ inputs


def decode_inputs(torch, ctx_lens, seed: int, num_blocks: int = 2112, hq=HQ, hkv=HKV, d=D):
    """Paged decode inputs at main-path shapes: each sequence owns distinct,
    randomly placed pages of a [hkv, num_blocks, BLOCK, d] bf16 cache."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    B = len(ctx_lens)
    pages = [(n + BLOCK - 1) // BLOCK for n in ctx_lens]
    if sum(pages) >= num_blocks:
        raise SmokeError("decode parity cache too small")
    perm = torch.randperm(num_blocks - 1, generator=g)[: sum(pages)] + 1
    tables = torch.zeros(B, MAX_BLOCKS, dtype=torch.int32)
    off = 0
    for b, n in enumerate(pages):
        tables[b, :n] = perm[off:off + n].to(torch.int32)
        off += n
    shape = (hkv, num_blocks, BLOCK, d)
    k = torch.randn(shape, generator=g).to(torch.bfloat16)
    v = torch.randn(shape, generator=g).to(torch.bfloat16)
    q = torch.randn(B, hq, d, generator=g).to(torch.bfloat16)
    lens = torch.tensor(ctx_lens, dtype=torch.int32)
    return [t.cuda() for t in (q, k, v, tables, lens)]


def prefill_inputs(torch, P: int, seed: int, hq: int = HQ, hkv: int = HKV, d: int = D):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(P, hq, d, generator=g).to(torch.bfloat16)
    k = torch.randn(P, hkv, d, generator=g).to(torch.bfloat16)
    v = torch.randn(P, hkv, d, generator=g).to(torch.bfloat16)
    return q.cuda(), k.cuda(), v.cuda()


def verify_inputs(torch, bases, draft_lens, S: int, seed: int, num_blocks: int = 2112,
                  hq=HQ, hkv=HKV, d=D):
    """Paged verify inputs: lane b feeds positions bases[b] .. bases[b]+S-1;
    its table covers only positions up to bases[b] + draft_lens[b] (a lane
    whose drafts stop early has entries 0 past its last block)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    B = len(bases)
    pages = [(p + d) // BLOCK + 1 for p, d in zip(bases, draft_lens)]
    if sum(pages) >= num_blocks:
        raise SmokeError("verify parity cache too small")
    perm = torch.randperm(num_blocks - 1, generator=g)[: sum(pages)] + 1
    tables = torch.zeros(B, MAX_BLOCKS, dtype=torch.int32)
    off = 0
    for b, n in enumerate(pages):
        tables[b, :n] = perm[off:off + n].to(torch.int32)
        off += n
    shape = (hkv, num_blocks, BLOCK, d)
    k = torch.randn(shape, generator=g).to(torch.bfloat16)
    v = torch.randn(shape, generator=g).to(torch.bfloat16)
    q = torch.randn(B, S, hq, d, generator=g).to(torch.bfloat16)
    pos = (torch.tensor(bases)[:, None] + torch.arange(S)[None, :]).to(torch.int32)
    return [t.cuda() for t in (q, k, v, tables, pos)]


def gemv_inputs(torch, M: int, seed: int, bias: bool = False, hq=HQ, hkv=HKV, d=D,
                hidden=HIDDEN):
    """The fused heads' inputs (Llama-3.1-8B width by default): residual
    rows x, the norm weight, wq / wk / wv / wo (std 0.02, as init_params
    draws them), cos / sin of random positions under llama3 rope scaling,
    and optional q/k/v biases."""
    from dynamo_tpu_torch.ops.basics import rope_freqs

    g = torch.Generator(device="cpu").manual_seed(seed)
    bf = torch.bfloat16
    x = torch.randn(M, hidden, generator=g).to(bf)
    norm = (1.0 + 0.1 * torch.randn(hidden, generator=g)).to(bf)
    wq = (0.02 * torch.randn(hidden, hq * d, generator=g)).to(bf)
    wk = (0.02 * torch.randn(hidden, hkv * d, generator=g)).to(bf)
    wv = (0.02 * torch.randn(hidden, hkv * d, generator=g)).to(bf)
    wo = (0.02 * torch.randn(hq * d, hidden, generator=g)).to(bf)
    attn = torch.randn(M, hq * d, generator=g).to(bf)
    pos = torch.randint(0, MAX_MODEL_LEN, (M,), generator=g)
    inv = rope_freqs(d, LLAMA31_8B["rope_theta"], LLAMA31_8B["rope_scaling"])
    angles = pos[:, None].float() * inv
    biases = (
        tuple((0.1 * torch.randn(n, generator=g)).to(bf) for n in (hq * d, hkv * d, hkv * d))
        if bias else (None, None, None)
    )
    cuda = lambda t: None if t is None else t.cuda()  # noqa: E731
    return {
        "x": cuda(x), "norm": cuda(norm), "wq": cuda(wq), "wk": cuda(wk),
        "wv": cuda(wv), "wo": cuda(wo), "attn": cuda(attn),
        "cos": cuda(torch.cos(angles)), "sin": cuda(torch.sin(angles)),
        "bq": cuda(biases[0]), "bk": cuda(biases[1]), "bv": cuda(biases[2]),
        "heads": (hq, hkv, d),
    }


def qkv_call(fn, t):
    hq, hkv, d = t.get("heads", (HQ, HKV, D))
    return fn(
        t["x"], t["norm"], t["wq"], t["wk"], t["wv"], t["cos"], t["sin"],
        eps=LLAMA31_8B["rms_norm_eps"], num_heads=hq, num_kv_heads=hkv,
        head_dim=d, bq=t["bq"], bk=t["bk"], bv=t["bv"],
    )


def compare(torch, name: str, got, want, tol) -> float:
    got = got.float()
    want = want.float()
    if not torch.isfinite(got).all():
        raise SmokeError(f"{name}: kernel output has non-finite values")
    err = (got - want).abs()
    bound = tol[0] + tol[1] * want.abs()
    worst = float(err.max())
    if bool((err > bound).any()):
        i = int((err - bound).argmax())
        raise SmokeError(
            f"{name}: kernel disagrees with the plain version: max |d| = "
            f"{worst:.3e}; at flat index {i}: kernel {float(got.flatten()[i]):.5f}"
            f" vs plain {float(want.flatten()[i]):.5f}"
        )
    return worst


# ------------------------------------------------------------------ phases

DECODE_LENS = [1, 16, 17, 300, 1000, 1777, 2500, 3001]
DECODE_CASES = [
    ("full", {}),
    ("window", {"window": 1024}),
    ("scale_softcap", {"scale": 0.125, "logit_softcap": 5.0}),
]
PREFILL_CASES = [
    ("P128", 128, 100, {}),
    ("P512", 512, 500, {}),
    ("P2048", 2048, 2000, {}),
    ("P2048_window", 2048, 1900, {"window": 512}),
    ("P512_scale_softcap", 512, 480, {"scale": 0.1, "logit_softcap": 5.0}),
    ("P1000_ragged", 1000, 999, {}),  # P not a multiple of the 128-row tile
]
# other GQA groups G = Hq / Hkv, Hkv fixed at 8: (name, Hq, P, valid_len)
PREFILL_GROUP_CASES = [("G1", HKV, 1000, 999), ("G8", 8 * HKV, 2048, 2000)]
# verify: B=8 lanes of S = spec_k + 1 = 4 positions, ragged bases, three
# lanes whose drafts stop early (their tables end at base + draft_len)
VERIFY_S = 4
VERIFY_BASES = [3, 100, 511, 1023, 1500, 2047, 2600, 2996]
VERIFY_DRAFT_LENS = [3, 3, 0, 1, 3, 2, 3, 3]
# fused heads: M = B (decode) and M = B * S (verify) rows, and a bias case
GEMV_CASES = [(8, False), (32, False), (32, True)]


def phase_parity(torch) -> dict:
    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops import cuda_attention as K

    errs = {"paged_decode_attention": 0.0, "flash_prefill_attention": 0.0}
    q, k, v, tables, lens = decode_inputs(torch, DECODE_LENS, seed=1)
    for name, kw in DECODE_CASES:
        got = K.paged_decode_attention_cuda(q, k, v, tables, lens, **kw)
        want = A.paged_decode_attention_plain(q, k, v, tables, lens, **kw)
        torch.cuda.synchronize()
        e = compare(torch, f"decode/{name}", got, want, DECODE_TOL)
        errs["paged_decode_attention"] = max(errs["paged_decode_attention"], e)
        log(f"parity decode/{name}: B={len(DECODE_LENS)} lens={DECODE_LENS} "
            f"max|d|={e:.3e} (tol {DECODE_TOL[0]:g} + {DECODE_TOL[1]:g}|x|)")
    prefill = [(name, HQ, P, vl, kw) for name, P, vl, kw in PREFILL_CASES]
    prefill += [(name, hq, P, vl, {}) for name, hq, P, vl in PREFILL_GROUP_CASES]
    for name, hq, P, vl, kw in prefill:
        q, k, v = prefill_inputs(torch, P, seed=P + vl + hq, hq=hq)
        got = K.flash_prefill_attention_cuda(q, k, v, vl, **kw)
        want = A.causal_prefill_attention_plain(q, k, v, vl, **kw)
        torch.cuda.synchronize()
        e = compare(torch, f"prefill/{name}", got[:vl], want[:vl], PREFILL_TOL)
        errs["flash_prefill_attention"] = max(errs["flash_prefill_attention"], e)
        log(f"parity prefill/{name}: P={P} valid_len={vl} Hq={hq} Hkv={HKV} {kw} "
            f"max|d|={e:.3e} (tol {PREFILL_TOL[0]:g} + {PREFILL_TOL[1]:g}|x|)")
    errs.update(spec_parity(torch))
    for name, e in shape_parity(torch).items():
        errs[name] = max(errs[name], e)
    return errs


def shape_parity(torch) -> dict:
    """#1-#4 at the other models' head shapes (HEAD_SHAPES): a GQA group of
    7 and head_dim 256, under the same tolerances."""
    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops import cuda_attention as K
    from dynamo_tpu_torch.ops import cuda_linear as KL
    from dynamo_tpu_torch.ops import linear as L

    errs = dict.fromkeys(("paged_decode_attention", "flash_prefill_attention",
                          "paged_verify_attention", "fused_qkv_rope"), 0.0)

    def check(kernel, label, got, want, tol):
        torch.cuda.synchronize()
        e = compare(torch, label, got, want, tol)
        errs[kernel] = max(errs[kernel], e)
        log(f"parity {label}: max|d|={e:.3e} (tol {tol[0]:g} + {tol[1]:g}|x|)")

    for name, (hq, hkv, d, hidden) in HEAD_SHAPES.items():
        shp = dict(hq=hq, hkv=hkv, d=d)
        tag = f"{name} Hq={hq} Hkv={hkv} D={d}"
        args = decode_inputs(torch, DECODE_LENS, seed=30, **shp)
        for case, kw in DECODE_CASES:
            check("paged_decode_attention", f"decode/{case} {tag}",
                  K.paged_decode_attention_cuda(*args, **kw),
                  A.paged_decode_attention_plain(*args, **kw), DECODE_TOL)
        args = verify_inputs(torch, VERIFY_BASES, VERIFY_DRAFT_LENS, VERIFY_S, seed=31, **shp)
        for case, kw in DECODE_CASES:
            check("paged_verify_attention", f"verify/{case} {tag}",
                  K.paged_verify_attention_cuda(*args, **kw),
                  A.paged_verify_attention_plain(*args, **kw), VERIFY_TOL)
        for case, P, vl, kw in (PREFILL_CASES[2], PREFILL_CASES[4], PREFILL_CASES[5]):
            q, k, v = prefill_inputs(torch, P, seed=32 + P, **shp)
            check("flash_prefill_attention", f"prefill/{case} {tag}",
                  K.flash_prefill_attention_cuda(q, k, v, vl, **kw)[:vl],
                  A.causal_prefill_attention_plain(q, k, v, vl, **kw)[:vl], PREFILL_TOL)
        for M in (8, 32):
            t = gemv_inputs(torch, M, seed=40 + M, bias=name == "qwen2_7b", hidden=hidden, **shp)
            got = qkv_call(KL.fused_qkv_rope_cuda, t)
            want = qkv_call(L.fused_qkv_rope_plain, t)
            for n, a, b in zip("qkv", got, want):
                check("fused_qkv_rope", f"qkv/M{M}/{n} {tag} hidden={hidden}", a, b, GEMV_TOL)
    return errs


def spec_parity(torch) -> dict:
    """The spec + fused path's kernels against their plain versions."""
    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops import cuda_attention as K
    from dynamo_tpu_torch.ops import cuda_linear as KL
    from dynamo_tpu_torch.ops import linear as L

    errs = {"paged_verify_attention": 0.0, "fused_qkv_rope": 0.0, "fused_attn_out_residual": 0.0}
    q, k, v, tables, pos = verify_inputs(torch, VERIFY_BASES, VERIFY_DRAFT_LENS, VERIFY_S, seed=4)
    for name, kw in DECODE_CASES:
        got = K.paged_verify_attention_cuda(q, k, v, tables, pos, **kw)
        want = A.paged_verify_attention_plain(q, k, v, tables, pos, **kw)
        torch.cuda.synchronize()
        e = compare(torch, f"verify/{name}", got, want, VERIFY_TOL)
        errs["paged_verify_attention"] = max(errs["paged_verify_attention"], e)
        log(f"parity verify/{name}: B={len(VERIFY_BASES)} S={VERIFY_S} bases={VERIFY_BASES} "
            f"draft_lens={VERIFY_DRAFT_LENS} max|d|={e:.3e} "
            f"(tol {VERIFY_TOL[0]:g} + {VERIFY_TOL[1]:g}|x|)")
    for M, bias in GEMV_CASES:
        t = gemv_inputs(torch, M, seed=10 + M, bias=bias)
        got = qkv_call(KL.fused_qkv_rope_cuda, t)
        want = qkv_call(L.fused_qkv_rope_plain, t)
        torch.cuda.synchronize()
        e = max(compare(torch, f"qkv/M{M}/{n}", a, b, GEMV_TOL) for n, a, b in zip("qkv", got, want))
        errs["fused_qkv_rope"] = max(errs["fused_qkv_rope"], e)
        log(f"parity fused_qkv_rope: M={M} bias={bias} llama3 rope max|d|={e:.3e} "
            f"(tol {GEMV_TOL[0]:g} + {GEMV_TOL[1]:g}|x|)")
        if bias:
            continue
        got = KL.fused_attn_out_residual_cuda(t["attn"], t["wo"], t["x"])
        want = L.fused_attn_out_residual_plain(t["attn"], t["wo"], t["x"])
        torch.cuda.synchronize()
        e = compare(torch, f"out/M{M}", got, want, GEMV_TOL)
        errs["fused_attn_out_residual"] = max(errs["fused_attn_out_residual"], e)
        log(f"parity fused_attn_out_residual: M={M} max|d|={e:.3e} "
            f"(tol {GEMV_TOL[0]:g} + {GEMV_TOL[1]:g}|x|)")
    return errs


def decode_bound(lens, B: int, hq=HQ, hkv=HKV, d=D, kv_bytes: int = 2) -> tuple[float, str, float, float]:
    """Least time for one paged decode call: every live K and V row read
    once (kv_bytes 1: int8 mantissas, plus each live page's k and v scale
    per head), q/tables/lens read once, the output written once; f32 work
    counted against the bf16 peak (the more generous one)."""
    keys = sum(lens)
    pages = sum((n + BLOCK - 1) // BLOCK for n in lens)
    nbytes = (
        2 * keys * hkv * d * kv_bytes  # K and V rows
        + 2 * B * hq * d * 2  # q in, out
        + pages * 4 + B * 4
        + (2 * pages * hkv * 4 if kv_bytes == 1 else 0)  # the pages' f32 scales
    )
    flops = 4 * keys * hq * d
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations", nbytes, flops


def prefill_bound(P: int, vl: int, window=None, hq=HQ, hkv=HKV, d=D) -> tuple[float, str, float, float]:
    """Least time for one prefill attention call: the valid rows of q, k, v
    read once, the [P] output written once; 4 * D flops per (query head,
    visible key) pair over the valid rows."""
    pairs = sum(min(i + 1, window or (i + 1)) for i in range(vl))
    flops = 4 * pairs * hq * d
    nbytes = (vl * (hq + 2 * hkv) * d + P * hq * d) * 2
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations", nbytes, flops


def decode_row(torch, flush, hq=HQ, hkv=HKV, d=D, plain_reps=20) -> dict:
    """#1 at chip_smoke's ragged contexts: kernel, plain and a yardstick."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops import cuda_attention as K

    lens = DECODE_LENS
    q, k, v, tables, lens_t = decode_inputs(torch, lens, seed=2, hq=hq, hkv=hkv, d=d)
    t_k = time_ms(torch, lambda: K.paged_decode_attention_cuda(q, k, v, tables, lens_t), flush=flush)
    t_p = time_ms(torch, lambda: A.paged_decode_attention_plain(q, k, v, tables, lens_t),
                  reps=plain_reps, flush=flush)
    # library time: SDPA over the same keys already gathered into a dense,
    # padded [B, Hq, S, D] layout with a length mask (the gather is not
    # timed; no PyTorch call takes the paged cache itself)
    S = max(lens)
    kd = torch.zeros(len(lens), hkv, S, d, dtype=torch.bfloat16, device="cuda")
    vd = torch.zeros_like(kd)
    for b, n in enumerate(lens):
        pages = tables[b, : (n + BLOCK - 1) // BLOCK].long()
        kd[b, :, :n] = k[:, pages].reshape(hkv, -1, d)[:, :n]
        vd[b, :, :n] = v[:, pages].reshape(hkv, -1, d)[:, :n]
    mask = (torch.arange(S, device="cuda")[None, :] < lens_t[:, None].long())[:, None, None, :]
    qd = q[:, :, None, :]
    t_s = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True), flush=flush)
    b_ms, b_by, nbytes, flops = decode_bound(lens, len(lens), hq, hkv, d)
    return {
        "ms": t_k, "plain_ms": t_p, "library_ms": t_s, "bound_ms": b_ms,
        "bound_by": b_by, "bytes": nbytes, "flops": flops,
        "shape": f"B={len(lens)} Hq={hq} Hkv={hkv} D={d} block={BLOCK} lens={lens}",
    }


def prefill_row(torch, flush, hq=HQ, hkv=HKV, d=D, plain_reps=5) -> dict:
    """#3 at P=2048, valid_len 2000: kernel, plain and causal GQA SDPA."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops import cuda_attention as K

    P, vl = 2048, 2000
    q, k, v = prefill_inputs(torch, P, seed=3, hq=hq, hkv=hkv, d=d)
    t_k = time_ms(torch, lambda: K.flash_prefill_attention_cuda(q, k, v, vl), flush=flush)
    t_p = time_ms(torch, lambda: A.causal_prefill_attention_plain(q, k, v, vl),
                  reps=plain_reps, warmup=1, flush=flush)
    qs = q[:vl].transpose(0, 1)[None]
    ks = k[:vl].transpose(0, 1)[None]
    vs = v[:vl].transpose(0, 1)[None]
    t_s = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True), flush=flush)
    b_ms, b_by, nbytes, flops = prefill_bound(P, vl, None, hq, hkv, d)
    return {
        "ms": t_k, "plain_ms": t_p, "library_ms": t_s, "bound_ms": b_ms,
        "bound_by": b_by, "bytes": nbytes, "flops": flops,
        "ratio_to_library": t_k["median"] / t_s["median"],
        "shape": f"P={P} valid_len={vl} Hq={hq} Hkv={hkv} D={d}",
    }


def phase_kernel_times(torch, card: str) -> dict:
    """Kernel / plain / yardstick times at main-path shapes, then #1-#3 at
    the other models' head shapes (HEAD_SHAPES)."""
    flush = make_flush(torch)
    rows = {}
    rows["paged_decode_attention"] = decode_row(torch, flush)
    rows["paged_decode_attention/step"] = decode_step_times(torch, flush)
    rows["flash_prefill_attention"] = prefill_row(torch, flush)
    rows.update(spec_kernel_times(torch, flush))
    for name, (hq, hkv, d, _) in HEAD_SHAPES.items():
        shp = dict(hq=hq, hkv=hkv, d=d)
        rows[f"paged_decode_attention/{name}"] = decode_row(torch, flush, plain_reps=5, **shp)
        rows[f"flash_prefill_attention/{name}"] = prefill_row(torch, flush, plain_reps=2, **shp)
        rows[f"paged_verify_attention/{name}"] = verify_row(torch, flush, **shp)
    for name, row in rows.items():
        print(json.dumps({"kernel_time": name, "card": card, **row}), flush=True)
    return rows


def decode_step_times(torch, flush) -> dict:
    """#1 at the B=8 decode step's own shape (every context 1025: position
    1024 and the keys before it; a 256-wide table, max_model_len 4096),
    beside one unmasked dense SDPA call with enable_gqa over the same keys
    gathered beforehand (not timed): every key is live, so that call
    computes the same function."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops import cuda_attention as K

    B, ctx = 8, STEP_CTX + 1
    q, k, v, tables, lens_t = decode_inputs(torch, [ctx] * B, seed=6)
    t_k = time_ms(torch, lambda: K.paged_decode_attention_cuda(q, k, v, tables, lens_t), flush=flush)
    t_p = time_ms(torch, lambda: A.paged_decode_attention_plain(q, k, v, tables, lens_t),
                  reps=5, flush=flush)
    pages = tables[:, : (ctx + BLOCK - 1) // BLOCK].long()
    kd = k[:, pages].reshape(HKV, B, -1, D)[:, :, :ctx].transpose(0, 1).contiguous()
    vd = v[:, pages].reshape(HKV, B, -1, D)[:, :, :ctx].transpose(0, 1).contiguous()
    qd = q[:, :, None, :]
    t_s = time_ms(torch, lambda: F.scaled_dot_product_attention(qd, kd, vd, enable_gqa=True),
                  flush=flush)
    b_ms, b_by, nbytes, flops = decode_bound([ctx] * B, B)
    return {
        "ms": t_k, "plain_ms": t_p, "library_ms": t_s, "bound_ms": b_ms, "bound_by": b_by,
        "bytes": nbytes, "flops": flops, "ratio_to_library": t_k["median"] / t_s["median"],
        "library": "SDPA over the keys gathered dense beforehand, no mask, enable_gqa",
        "shape": f"B={B} ctx={ctx} Hq={HQ} Hkv={HKV} D={D} block={BLOCK} table {MAX_BLOCKS} wide",
    }


def verify_bound(bases, S: int, hq=HQ, hkv=HKV, d=D, kv_bytes: int = 2) -> tuple[float, str, float, float]:
    """Least time for one verify call: each lane's live K and V rows (its
    context, base + S keys; kv_bytes 1: int8, plus the pages' scales) read
    once, q / tables / positions read once, the output written once;
    4 * D flops per (query head, visible key) pair."""
    keys = sum(p + S for p in bases)
    pairs = sum(p + s + 1 for p in bases for s in range(S))
    pages = sum((p + S + BLOCK - 1) // BLOCK for p in bases)
    nbytes = (
        2 * keys * hkv * d * kv_bytes + 2 * len(bases) * S * hq * d * 2
        + pages * 4 + len(bases) * S * 4
        + (2 * pages * hkv * 4 if kv_bytes == 1 else 0)
    )
    flops = 4 * pairs * hq * d
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations", nbytes, flops


def gemv_bound(M: int, K: int, N: int, extra_bytes: int, w_bytes: int = 2) -> tuple[float, str, float, float]:
    """Least time for a fused head: the [K, N] weights (bf16, or w_bytes 1:
    int8 plus a bf16 scale per column), the [M, K] input and the [M, N]
    output moved once, plus `extra_bytes` (norm weight, cos / sin,
    residual); 2 * M * K * N flops."""
    nbytes = K * N * w_bytes + (M * K + M * N) * 2 + extra_bytes + (N * 2 if w_bytes == 1 else 0)
    flops = 2 * M * K * N
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations", nbytes, flops


def verify_row(torch, flush, hq=HQ, hkv=HKV, d=D) -> dict:
    """#2 at the verify shape (B=8, S=4): kernel, plain and a yardstick."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops import cuda_attention as K

    S, bases = VERIFY_S, VERIFY_BASES
    full = [S - 1] * len(bases)  # every lane drafted S - 1 tokens
    q, k, v, tables, pos = verify_inputs(torch, bases, full, S, seed=5, hq=hq, hkv=hkv, d=d)
    t_k = time_ms(torch, lambda: K.paged_verify_attention_cuda(q, k, v, tables, pos), flush=flush)
    t_p = time_ms(torch, lambda: A.paged_verify_attention_plain(q, k, v, tables, pos),
                  reps=5, flush=flush)
    # yardstick: SDPA over the same keys gathered dense beforehand (not
    # timed), [B, Hkv, ctx, D], with each query row's causal mask
    ctx = max(bases) + S
    kd = torch.zeros(len(bases), hkv, ctx, d, dtype=torch.bfloat16, device="cuda")
    vd = torch.zeros_like(kd)
    for b, p in enumerate(bases):
        n = p + S
        pages = tables[b, : (n + BLOCK - 1) // BLOCK].long()
        kd[b, :, :n] = k[:, pages].reshape(hkv, -1, d)[:, :n]
        vd[b, :, :n] = v[:, pages].reshape(hkv, -1, d)[:, :n]
    mask = torch.arange(ctx, device="cuda")[None, None, :] <= pos.long()[:, :, None]
    qd = q.transpose(1, 2)  # [B, Hq, S, D]
    t_s = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask[:, None], enable_gqa=True), flush=flush)
    b_ms, b_by, nbytes, flops = verify_bound(bases, S, hq, hkv, d)
    return {
        "ms": t_k, "plain_ms": t_p, "library_ms": t_s, "bound_ms": b_ms,
        "bound_by": b_by, "bytes": nbytes, "flops": flops,
        "library": "SDPA over keys gathered dense beforehand, causal mask",
        "shape": f"B={len(bases)} S={S} Hq={hq} Hkv={hkv} D={d} block={BLOCK} bases={bases}",
    }


def spec_kernel_times(torch, flush) -> dict:
    """The spec + fused path's kernels: kernel / plain / yardstick times at
    the verify shape (B=8, S=4) and the fused heads at M = 8 (a decode
    step) and M = 32 (a verify step)."""
    from dynamo_tpu_torch.ops import cuda_linear as KL
    from dynamo_tpu_torch.ops import linear as L
    from dynamo_tpu_torch.ops.basics import rms_norm

    rows = {"paged_verify_attention": verify_row(torch, flush)}
    eps = LLAMA31_8B["rms_norm_eps"]
    for M in (8, 32):
        t = gemv_inputs(torch, M, seed=20 + M)
        wqkv = torch.cat([t["wq"], t["wk"], t["wv"]], dim=1)  # built beforehand
        inv = torch.ones(D // 2, device="cuda")

        def chain():  # the unfused chain: rms_norm -> one matmul -> rope
            from dynamo_tpu_torch.ops.basics import apply_rope

            y = torch.matmul(rms_norm(t["x"], t["norm"], eps), wqkv)
            qh = y[:, : HQ * D].reshape(M, HQ, D)
            kh = y[:, HQ * D: (HQ + HKV) * D].reshape(M, HKV, D)
            p = torch.arange(M, device="cuda")
            return apply_rope(qh, p, inv), apply_rope(kh, p, inv)

        N = (HQ + 2 * HKV) * D
        xn = rms_norm(t["x"], t["norm"], eps)  # normed beforehand, not timed
        t_k = time_ms(torch, lambda: qkv_call(KL.fused_qkv_rope_cuda, t), flush=flush)
        t_p = time_ms(torch, lambda: qkv_call(L.fused_qkv_rope_plain, t), flush=flush)
        t_s = time_ms(torch, chain, flush=flush)
        t_m = time_ms(torch, lambda: torch.matmul(xn, wqkv), flush=flush)
        b_ms, b_by, nbytes, flops = gemv_bound(M, HIDDEN, N, HIDDEN * 2 + M * D * 4)
        rows[f"fused_qkv_rope/M{M}"] = {
            "ms": t_k, "plain_ms": t_p, "library_ms": t_m, "chain_ms": t_s,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
            "ratio_to_library": t_k["median"] / t_m["median"],
            "library": "torch.matmul(xn, [wq|wk|wv]) over a pre-normed x: one cuBLAS "
                       "call for the product alone (no norm, bias or RoPE)",
            "chain": "rms_norm -> matmul on [wq|wk|wv] -> apply_rope (q, k)",
            "shape": f"M={M} hidden={HIDDEN} N={N} (Hq {HQ}, Hkv {HKV}, D {D})",
        }
        t_k = time_ms(torch, lambda: KL.fused_attn_out_residual_cuda(t["attn"], t["wo"], t["x"]),
                      flush=flush)
        t_p = time_ms(torch, lambda: L.fused_attn_out_residual_plain(t["attn"], t["wo"], t["x"]),
                      flush=flush)
        t_s = time_ms(torch, lambda: torch.addmm(t["x"], t["attn"], t["wo"]), flush=flush)
        b_ms, b_by, nbytes, flops = gemv_bound(M, HQ * D, HIDDEN, M * HIDDEN * 2)
        rows[f"fused_attn_out_residual/M{M}"] = {
            "ms": t_k, "plain_ms": t_p, "library_ms": t_s, "bound_ms": b_ms,
            "bound_by": b_by, "bytes": nbytes, "flops": flops,
            "ratio_to_library": t_k["median"] / t_s["median"],
            "library": "torch.addmm(x, attn, wo)",
            "shape": f"M={M} K={HQ * D} N={HIDDEN}",
        }
    return rows


# ------------------------------------------------------------------ serve

# meta-llama/Llama-3.1-8B config.json as published on the Hugging Face hub
# (huggingface.co/meta-llama/Llama-3.1-8B/blob/main/config.json)
LLAMA31_8B = {
    "architectures": ["LlamaForCausalLM"],
    "attention_bias": False,
    "bos_token_id": 128000,
    "eos_token_id": 128001,
    "hidden_act": "silu",
    "hidden_size": 4096,
    "intermediate_size": 14336,
    "max_position_embeddings": 131072,
    "mlp_bias": False,
    "model_type": "llama",
    "num_attention_heads": 32,
    "num_hidden_layers": 32,
    "num_key_value_heads": 8,
    "rms_norm_eps": 1e-05,
    "rope_scaling": {
        "factor": 8.0,
        "low_freq_factor": 1.0,
        "high_freq_factor": 4.0,
        "original_max_position_embeddings": 8192,
        "rope_type": "llama3",
    },
    "rope_theta": 500000.0,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
    "vocab_size": 128256,
}
# the main phases' model (serve, serve_spec, serve_default, serve_int8, times,
# serve_horizon, serve_disagg; see the module docstring): Llama-3.1-8B's
# width, every kernel at its shapes, at half its depth, so the script fits
# its time limit beside the parallel legs; serve_offload and serve_peer (whose
# tiers are sized in GiB of full-depth blocks) build the full 32 layers
MAIN_LAYERS = 16
MAIN_MODEL = dict(LLAMA31_8B, num_hidden_layers=MAIN_LAYERS)
PROMPT_LENS = [16, 100, 300, 517, 800, 1200, 1600, 2000]
MAX_TOKENS = [32, 40, 48, 56, 64, 32, 48, 64]
SAMPLED = 3  # index of the one seeded, sampled request
# index of the one request with frequency / presence / repetition penalties
# and min_tokens (greedy, the model's EOS id as its stop id)
PENALIZED = 5
PENALTIES = {"frequency_penalty": 0.5, "presence_penalty": 0.5, "repetition_penalty": 1.2}
MIN_TOKENS = 24


def make_requests(np, PreprocessedRequest, SamplingOptions, StopConditions,
                  vocab: int = LLAMA31_8B["vocab_size"], eos_id: int = LLAMA31_8B["eos_token_id"]):
    rng = np.random.default_rng(0)
    reqs = []
    for i, (n, m) in enumerate(zip(PROMPT_LENS, MAX_TOKENS)):
        prompt = rng.integers(0, vocab, n).tolist()
        sampling = (
            SamplingOptions(temperature=0.8, top_p=0.95, top_k=50, seed=1234)
            if i == SAMPLED else SamplingOptions(greedy=True)
        )
        # no eos ids: random weights may emit any id, and every request must
        # run to its max_tokens so the counts can be checked -- but the
        # penalised one, whose EOS stays masked until min_tokens
        eos, min_tokens = [], None
        if i == PENALIZED:
            sampling = SamplingOptions(greedy=True, **PENALTIES)
            eos, min_tokens = [eos_id], MIN_TOKENS
        reqs.append(PreprocessedRequest(
            token_ids=prompt, sampling=sampling,
            stop=StopConditions(max_tokens=m, min_tokens=min_tokens), eos_token_ids=eos,
        ))
    return reqs


async def run_requests(engine, reqs, Context, gaps: Optional[list] = None):
    """Each request's (tokens, finish reason, TTFT s), served concurrently;
    ``gaps`` gathers every inter-token gap (s) of every request."""
    async def one(req):
        toks, reason, t0, ttft, last = [], None, time.perf_counter(), None, None
        async for out in engine.generate(req, Context()):
            now = time.perf_counter()
            if out.token_ids and ttft is None:
                ttft = now - t0
            for _ in out.token_ids:
                if gaps is not None and last is not None:
                    gaps.append(now - last)
                last = now
            toks.extend(out.token_ids)
            if out.finish_reason is not None:
                reason = out.finish_reason
                if out.error:
                    raise SmokeError(f"request failed: {out.error}")
        return toks, reason, ttft

    return await asyncio.gather(*(one(r) for r in reqs))


def dense_logits(torch, runner, seq: list):
    """The plain reference's logits over ``seq``: one forward, the plain
    attention version, no cache, the runner's own weights."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops.layers import attn_out, qkv_head

    cfg, params = runner.config, runner.params
    with torch.inference_mode():
        tokens = torch.tensor(seq, device=runner.device)
        positions = torch.arange(len(seq), device=runner.device)
        freqs = llama._rope_pair(cfg, tokens.device)
        x = llama._embed(params, cfg, tokens)
        for i, layer in enumerate(params["layers"]):
            q, k, v = qkv_head(x, layer, cfg, llama._layer_freqs(cfg, i, freqs), positions)
            attn = A.causal_prefill_attention_plain(q, k, v, len(seq))
            x = llama._mlp(attn_out(attn, x, layer, cfg), layer, cfg)
        return llama._logits(x, params, cfg)


def reference_check(torch, runner, prompt, generated, n_check: int = 8,
                    bound: float = 0.25) -> float:
    """Dense reference of the first tokens: one forward over prompt +
    generated[:n_check] with the plain attention version and no cache, over
    the runner's own weights (int8 ones through the int8 products); each
    greedy token of the engine must be the reference's argmax up to bf16
    noise (and, with an int8 cache, quantization noise: `bound`). Returns
    the largest logit gap seen."""
    logits = dense_logits(torch, runner, prompt + generated[:n_check])
    worst = 0.0
    for j in range(n_check):
        row = logits[len(prompt) - 1 + j]
        gap = float(row.max() - row[generated[j]])
        worst = max(worst, gap)
        # bf16 activations: the kernel path and the dense path round
        # differently, so near-ties may flip; a real fault moves far more
        if gap > bound:
            raise SmokeError(
                f"engine token {generated[j]} at step {j} is {gap:.3f} below "
                f"the reference's best logit"
            )
    return worst


def phase_serve(torch, np, card: str) -> dict:
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.ops import kernels
    from dynamo_tpu_torch.protocols.common import (
        Context, FinishReason, PreprocessedRequest, SamplingOptions, StopConditions,
    )

    t0 = time.perf_counter()
    mem_before = torch.cuda.memory_allocated()
    # chunking off: every prompt through the single-shot prefill (#3), the
    # path this phase has always measured
    engine = build_torch_engine(
        MAIN_MODEL, device="cuda", max_batch=8, max_model_len=MAX_MODEL_LEN, seed=0,
        fused_decode=False, spec_k=0, prefill_chunk_tokens=0, **EAGER,
    )
    torch.cuda.synchronize()
    runner = engine.runner
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(runner.params))
    log(f"serve: engine built in {time.perf_counter() - t0:.1f} s; weights "
        f"{wbytes / 1e9:.2f} GB, KV pool {runner.num_blocks} blocks "
        f"({runner.kv_cache_bytes / 1e9:.2f} GB)")
    reqs = make_requests(np, PreprocessedRequest, SamplingOptions, StopConditions)

    async def serve():
        try:
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            first = await run_requests(engine, reqs, Context)
            wall = time.perf_counter() - t1
            stats = stats_dict(engine.stats)
            launches = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            # the same requests again: must repeat, and time the engine warm
            # (the first run pays one-time set-up: library handles on the
            # engine's worker thread, first use of each matmul shape)
            t1 = time.perf_counter()
            second = await run_requests(engine, reqs, Context)
            return first, second, wall, time.perf_counter() - t1, stats, launches, peak
        finally:
            await engine.close()

    first, second, wall, wall_warm, stats, launches, peak = asyncio.run(serve())
    vocab = LLAMA31_8B["vocab_size"]
    pen_toks, pen_reason = first[PENALIZED][0], first[PENALIZED][1]
    if len(pen_toks) < MIN_TOKENS or pen_reason not in (FinishReason.LENGTH, FinishReason.EOS):
        raise SmokeError(f"penalised request: {len(pen_toks)} tokens, reason {pen_reason}; "
                         f"expected at least min_tokens {MIN_TOKENS}")
    log(f"serve: the penalised request ({PENALTIES}, min_tokens {MIN_TOKENS}) streamed "
        f"{len(pen_toks)} tokens, reason {pen_reason.value}")
    for i, ((toks, reason, _), req) in enumerate(zip(first, reqs)):
        if i == PENALIZED:
            if not all(0 <= t < vocab for t in toks) or second[i][0] != toks:
                raise SmokeError("penalised request: bad ids, or the repeat differed")
            continue
        if reason is not FinishReason.LENGTH or len(toks) != req.stop.max_tokens:
            raise SmokeError(
                f"request {i}: {len(toks)} tokens, reason {reason}; expected "
                f"{req.stop.max_tokens} and length"
            )
        if not all(0 <= t < vocab for t in toks):
            raise SmokeError(f"request {i}: token id outside the vocab")
        if second[i][0] != toks:
            raise SmokeError(f"request {i}: the repeated run gave other tokens")
    n_layers = runner.config.num_layers
    want = {
        **dict.fromkeys(kernels.KERNELS, 0),  # spec and fused decode are off
        "paged_decode_attention": n_layers * stats["decode_steps"],
        "flash_prefill_attention": n_layers * stats["prefills"],
    }
    if launches != want:
        raise SmokeError(f"kernel launches {launches} != layers x steps {want}")
    # the shortest and the longest prompt, both greedy
    gap = max(reference_check(torch, runner, reqs[i].token_ids, first[i][0]) for i in (0, -1))
    out_tokens = sum(len(t) for t, _, _ in first)
    res = {
        "requests": len(reqs), "prompt_lens": PROMPT_LENS, "max_tokens": MAX_TOKENS,
        "stats": stats, "launches": launches, "wall_s": wall,
        "output_tok_per_s": out_tokens / wall,
        "ttft_s_concurrent": [t for _, _, t in first],
        "wall_s_warm": wall_warm, "output_tok_per_s_warm": out_tokens / wall_warm,
        "ttft_s_concurrent_warm": [t for _, _, t in second],
        "peak_mem_bytes": peak, "engine_peak_mem_bytes": peak - mem_before,
        "reference_max_logit_gap": gap,
        "penalized_request": {"sampling": PENALTIES, "min_tokens": MIN_TOKENS,
                              "tokens": len(pen_toks), "reason": pen_reason.value},
    }
    log(f"serve: {len(reqs)} requests ({out_tokens} tokens) in {wall:.2f} s "
        f"({wall_warm:.2f} s warm); "
        f"{stats['prefills']} prefills, {stats['decode_steps']} decode steps; "
        f"launches {launches}; repeat identical; reference gap {gap:.3f}")
    print(json.dumps({"serve": res, "card": card}), flush=True)
    res["engine"] = engine
    return res


SPEC_K = 3
SPEC_MAX_TOKENS = 64
# one drafting lane of eight is enough for a verify dispatch: at B=8 the
# card is weight-bound, so scoring S=4 positions per lane costs about what
# one plain step costs (the JAX engine's advice for such chips)
SPEC_COVERAGE = 0.125
SPEC_KERNELS = ("paged_verify_attention", "fused_qkv_rope", "fused_attn_out_residual")


async def repeating_prompts(np, engine, PreprocessedRequest, SamplingOptions, StopConditions,
                            Context):
    """Quoting traffic for the n-gram drafter: per request, random filler,
    then a numpy-seeded 32-128-token segment s followed by the model's own
    greedy continuation of it, 2-4 times over, ending on s again. Each
    continuation is generated (by `engine`, spec off) in the context of the
    copies before it, so the text after the last s is what the model says
    there and the drafter finds it earlier in the prompt. 400-1500 tokens
    per prompt."""
    rng = np.random.default_rng(2)
    vocab = LLAMA31_8B["vocab_size"]
    plans = []
    for _ in range(8):
        seg = rng.integers(0, vocab, int(rng.integers(32, 129))).tolist()
        copies = int(rng.integers(2, 5))
        body = copies * len(seg) + (copies - 1) * SPEC_MAX_TOKENS
        fill = max(0, int(rng.integers(400, 1501)) - body)
        plans.append([rng.integers(0, vocab, fill).tolist(), seg, copies])
    prompts = [fill + seg for fill, seg, _ in plans]

    def greedy(p):
        return PreprocessedRequest(
            token_ids=p, sampling=SamplingOptions(greedy=True),
            stop=StopConditions(max_tokens=SPEC_MAX_TOKENS), eos_token_ids=[],
        )

    for rnd in range(max(c for _, _, c in plans) - 1):
        live = [i for i, (_, _, c) in enumerate(plans) if rnd < c - 1]
        outs = await run_requests(engine, [greedy(prompts[i]) for i in live], Context)
        for i, (toks, _, _) in zip(live, outs):
            prompts[i] = prompts[i] + toks + plans[i][1]
    reqs = [greedy(p) for p in prompts]
    reqs[SAMPLED].sampling = SamplingOptions(temperature=0.8, top_p=0.95, top_k=50, seed=1234)
    return reqs


def phase_serve_spec(torch, np, card: str, params) -> dict:
    """The spec + fused path: TorchEngine with fused_decode and spec_k=3
    over the serve phase's weights (shared, not copied), on repeating
    traffic; and the same traffic through a spec-off engine, for tokens/s
    with spec off and on."""
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.ops import kernels
    from dynamo_tpu_torch.protocols.common import (
        Context, FinishReason, PreprocessedRequest, SamplingOptions, StopConditions,
    )

    def build(spec_k):
        return build_torch_engine(
            MAIN_MODEL, device="cuda", max_batch=8, max_model_len=MAX_MODEL_LEN,
            seed=0, fused_decode=True, spec_k=spec_k, params=params,
            spec_min_coverage=SPEC_COVERAGE, prefill_chunk_tokens=0, **EAGER,
        )

    plain, spec = build(0), build(SPEC_K)

    async def serve():
        try:
            t0 = time.perf_counter()
            reqs = await repeating_prompts(np, plain, PreprocessedRequest, SamplingOptions,
                                           StopConditions, Context)
            log(f"serve_spec: repeating traffic built in {time.perf_counter() - t0:.1f} s; "
                f"prompt lengths {[len(r.token_ids) for r in reqs]}")
            kernels.reset_launch_counts()
            t1 = time.perf_counter()
            first = await run_requests(spec, reqs, Context)
            wall = time.perf_counter() - t1
            stats = stats_dict(spec.stats)
            launches = kernels.launch_counts()
            # warm: the same traffic through spec off, spec on, spec on,
            # spec off (the host's speed drifts; the pairs straddle it)
            walls = {"off": [], "on": []}
            outs = {}
            for name, eng in (("off", plain), ("on", spec), ("on", spec), ("off", plain)):
                t1 = time.perf_counter()
                outs[name] = await run_requests(eng, reqs, Context)
                walls[name].append(time.perf_counter() - t1)
            return reqs, first, outs, wall, walls, stats, launches
        finally:
            await spec.close()
            await plain.close()

    reqs, first, outs, wall, walls, stats, launches = asyncio.run(serve())
    lens = [len(r.token_ids) for r in reqs]
    for i, ((toks, reason, _), req) in enumerate(zip(first, reqs)):
        if reason is not FinishReason.LENGTH or len(toks) != SPEC_MAX_TOKENS:
            raise SmokeError(f"spec request {i}: {len(toks)} tokens, reason {reason}")
    if outs["on"][SAMPLED][0] != first[SAMPLED][0]:
        raise SmokeError("spec: the seeded sampled request did not repeat")
    if stats["verify_steps"] < 4:
        raise SmokeError(f"spec: only {stats['verify_steps']} verify dispatches (want >= 4): {stats}")
    L, steps = spec.runner.config.num_layers, stats["decode_steps"]
    verify = stats["verify_steps"]
    want = {
        **dict.fromkeys(kernels.KERNELS, 0),  # the int8 modes: not on this path
        "paged_decode_attention": L * steps,
        "flash_prefill_attention": L * stats["prefills"],
        "paged_verify_attention": L * verify,
        "fused_qkv_rope": L * (steps + verify),
        "fused_attn_out_residual": L * (steps + verify),
    }
    if launches != want:
        raise SmokeError(f"spec: kernel launches {launches} != layers x dispatches {want}")
    # every greedy lane's first 32 tokens, most of them from verify
    # dispatches, against a dense reference of the same weights
    gap = max(
        reference_check(torch, spec.runner, reqs[i].token_ids, first[i][0], n_check=32)
        for i in range(len(reqs)) if i != SAMPLED
    )
    out_tokens = len(reqs) * SPEC_MAX_TOKENS
    same = sum(a[0] == b[0] for a, b in zip(outs["on"], outs["off"]))
    # bf16: spec on and off round differently (verify vs decode attention,
    # 32- vs 8-row products), so a near-tie may flip and the lane diverge
    prefix = []
    for a, b in zip(outs["on"], outs["off"]):
        n = 0
        while n < min(len(a[0]), len(b[0])) and a[0][n] == b[0][n]:
            n += 1
        prefix.append(n)
    rate = {k: out_tokens / statistics.median(v) for k, v in walls.items()}
    res = {
        "requests": len(reqs), "prompt_lens": lens, "max_tokens": SPEC_MAX_TOKENS,
        "spec_k": SPEC_K, "stats": stats, "launches": launches, "wall_s_cold": wall,
        "wall_s_warm": walls, "output_tok_per_s_warm": rate,
        "acceptance": stats["num_accepted_tokens"] / max(1, stats["num_draft_tokens"]),
        "tokens_per_verify_lane": (stats["num_accepted_tokens"] + stats["num_drafts"])
        / max(1, stats["num_drafts"]),
        "requests_identical_spec_on_off": same, "common_prefix_spec_on_off": prefix,
        "reference_max_logit_gap": gap,
    }
    log(f"serve_spec: {verify} verify dispatches, {steps} plain decode steps, "
        f"{stats['prefills']} prefills; drafts {stats['num_drafts']} "
        f"({stats['num_draft_tokens']} tokens), accepted {stats['num_accepted_tokens']} "
        f"per position {stats['accepted_per_pos']}; launches {launches}; "
        f"warm tokens/s off {rate['off']:.1f} on {rate['on']:.1f}; "
        f"{same}/8 requests identical spec on/off (common prefixes {prefix}); "
        f"reference gap {gap:.3f} over 32 tokens of each greedy lane")
    print(json.dumps({"serve_spec": res, "card": card}), flush=True)
    res["runner"] = spec.runner
    res["reqs"] = reqs
    return res


# --------------------------------------------------- default admission path


def phase_serve_default(torch, np, card: str, params) -> dict:
    """The reference's default single-worker path: build_torch_engine with
    its defaults over the serve phase's weights (shared), the same 8
    requests (16-2000 tokens; prompts of up to 512 tokens are packed, the
    others chunked, 512 tokens at a time, two chunks per mixed step)."""
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.ops import kernels
    from dynamo_tpu_torch.protocols.common import (
        Context, FinishReason, PreprocessedRequest, SamplingOptions, StopConditions,
    )

    engine = build_torch_engine(
        MAIN_MODEL, device="cuda", max_batch=8, max_model_len=MAX_MODEL_LEN, seed=0,
        fused_decode=False, spec_k=0, params=params, **EAGER,
    )
    runner = engine.runner
    if runner.prefill_chunk_tokens != 512 or not engine._mixed_enabled:
        raise SmokeError(f"serve_default: chunk {runner.prefill_chunk_tokens}, mixed "
                         f"{engine._mixed_enabled}; expected the defaults (512, on)")
    reqs = make_requests(np, PreprocessedRequest, SamplingOptions, StopConditions)

    async def serve():
        try:
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            first = await run_requests(engine, reqs, Context)
            wall = time.perf_counter() - t1
            stats = stats_dict(engine.stats)
            launches = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            t1 = time.perf_counter()
            second = await run_requests(engine, reqs, Context)
            return first, second, wall, time.perf_counter() - t1, stats, launches, peak
        finally:
            await engine.close()

    first, second, wall, wall_warm, stats, launches, peak = asyncio.run(serve())
    vocab = LLAMA31_8B["vocab_size"]
    for i, ((toks, reason, _), req) in enumerate(zip(first, reqs)):
        if i == PENALIZED:
            ok = len(toks) >= MIN_TOKENS and reason in (FinishReason.LENGTH, FinishReason.EOS)
        else:
            ok = reason is FinishReason.LENGTH and len(toks) == req.stop.max_tokens
        if not ok or not all(0 <= t < vocab for t in toks):
            raise SmokeError(f"serve_default request {i}: {len(toks)} tokens, reason {reason}")
        if second[i][0] != toks:
            raise SmokeError(f"serve_default request {i}: the repeated run gave other tokens")
    if stats["mixed_steps"] <= 0 or stats["packed_prefills"] <= 0 or stats["prefills"]:
        raise SmokeError(f"serve_default: did not pack and mix: {stats}")
    L = runner.config.num_layers
    want = {**dict.fromkeys(kernels.KERNELS, 0),
            "paged_decode_attention": L * (stats["decode_steps"] + stats["mixed_steps"])}
    if launches != want:
        raise SmokeError(f"serve_default: kernel launches {launches} != {want}")
    # the shortest (packed) and the longest (chunked) prompt, both greedy
    gap = max(reference_check(torch, runner, reqs[i].token_ids, first[i][0]) for i in (0, -1))
    out_tokens = sum(len(t) for t, _, _ in first)
    res = {
        "requests": len(reqs), "prompt_lens": PROMPT_LENS, "stats": stats,
        "launches": launches, "wall_s": wall, "output_tok_per_s": out_tokens / wall,
        "ttft_s_concurrent": [t for _, _, t in first], "wall_s_warm": wall_warm,
        "output_tok_per_s_warm": out_tokens / wall_warm,
        "ttft_s_concurrent_warm": [t for _, _, t in second], "peak_mem_bytes": peak,
        "reference_max_logit_gap": gap, "chunk": runner.prefill_chunk_tokens,
        "chunk_budget": engine._chunk_budget_base,
    }
    log(f"serve_default: {len(reqs)} requests ({out_tokens} tokens) in {wall:.2f} s "
        f"({wall_warm:.2f} s warm); {stats['packed_prefills']} packed prefills, "
        f"{stats['chunk_steps']} chunks alone, {stats['mixed_steps']} mixed steps, "
        f"{stats['decode_steps']} decode steps; launches {launches}; repeat identical; "
        f"reference gap {gap:.3f}; peak memory {peak / 1e9:.2f} GB")
    print(json.dumps({"serve_default": res, "card": card}), flush=True)
    res["engine"] = engine
    return res


def chunked_row(torch, flush, C: int = 512, start: int = 1536) -> dict:
    """The chunked prefill attention op (a torch op on the card: the JAX
    package's is an XLA op) at C rows from position `start`, against a
    max_model_len-wide table, beside SDPA over the visible keys gathered
    beforehand (not timed) with the op's causal mask."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import attention as A

    g = torch.Generator(device="cpu").manual_seed(7)
    nb = 2112
    kc = torch.randn(HKV, nb, BLOCK, D, generator=g).to(torch.bfloat16).cuda()
    vc = torch.randn(HKV, nb, BLOCK, D, generator=g).to(torch.bfloat16).cuda()
    q = torch.randn(C, HQ, D, generator=g).to(torch.bfloat16).cuda()
    S = start + C
    table = torch.zeros(MAX_BLOCKS, dtype=torch.int64)
    table[:S // BLOCK] = torch.randperm(nb - 1, generator=g)[:S // BLOCK] + 1
    table = table.cuda()
    t_op = time_ms(torch, lambda: A.chunked_prefill_attention(q, kc, vc, table, start),
                   reps=10, warmup=2, flush=flush)
    ks = kc[:, table[:S // BLOCK]].reshape(HKV, S, D)[None]
    vs = vc[:, table[:S // BLOCK]].reshape(HKV, S, D)[None]
    qpos = start + torch.arange(C, device="cuda")
    mask = torch.arange(S, device="cuda")[None, :] <= qpos[:, None]
    qs = q.transpose(0, 1)[None]
    t_s = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True), flush=flush)
    got = A.chunked_prefill_attention(q, kc, vc, table, start)
    want = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    err = compare(torch, "chunked op vs SDPA", got, want[0].transpose(0, 1), PREFILL_TOL)
    pairs = C * start + C * (C + 1) // 2
    flops = 4 * pairs * HQ * D
    nbytes = (2 * C * HQ * D + 2 * S * HKV * D) * 2 + (S // BLOCK) * 8
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return {"ms": t_op, "sdpa_pregathered_ms": t_s, "bound_ms": max(t_b, t_f) * 1e3,
            "bound_by": "bytes" if t_b >= t_f else "operations", "bytes": nbytes,
            "flops": flops, "max_abs_diff_vs_sdpa": err,
            "shape": f"C={C} chunk_start={start} Hq={HQ} Hkv={HKV} D={D} table={MAX_BLOCKS}"}


PACKED_SEGMENTS = [16, 100, 300]  # the serve phase's three short prompts


def packed_row(torch, flush, P: int = 512) -> dict:
    """The packed prefill attention op (a torch op on the card) over the
    short prompts the default path packs into one 512-row buffer, beside
    SDPA with the same block-diagonal causal mask."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import attention as A

    q, k, v = prefill_inputs(torch, P, seed=8)
    seg = torch.full((P,), -1, dtype=torch.int64)
    off = 0
    for i, n in enumerate(PACKED_SEGMENTS):
        seg[off:off + n] = i
        off += n
    seg = seg.cuda()
    t_op = time_ms(torch, lambda: A.packed_prefill_attention(q, k, v, seg),
                   reps=10, warmup=2, flush=flush)
    pos = torch.arange(P, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (seg[None, :] == seg[:, None])
    qs, ks, vs = (t.transpose(0, 1)[None] for t in (q, k, v))
    t_s = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True), flush=flush)
    got = A.packed_prefill_attention(q, k, v, seg)[:off]
    want = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    err = compare(torch, "packed op vs SDPA", got, want[0].transpose(0, 1)[:off], PREFILL_TOL)
    pairs = sum(n * (n + 1) // 2 for n in PACKED_SEGMENTS)
    flops = 4 * pairs * HQ * D
    nbytes = (2 * P * HQ * D + 2 * P * HKV * D) * 2 + P * 8
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return {"ms": t_op, "sdpa_masked_ms": t_s, "bound_ms": max(t_b, t_f) * 1e3,
            "bound_by": "bytes" if t_b >= t_f else "operations", "bytes": nbytes,
            "flops": flops, "max_abs_diff_vs_sdpa": err,
            "shape": f"P={P} segments={PACKED_SEGMENTS} Hq={HQ} Hkv={HKV} D={D}"}


def top_kernels(kernels: dict, calls: int, n: int = 8) -> list:
    """The n kernels with the most device time in a profile of `calls`
    calls: [name (cut to 100 characters), us per call, launches per call]."""
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:n]
    return [[k[:100], us / calls, c / calls] for k, (us, c) in rows]


def admission_times(torch, np, engine, card: str) -> dict:
    """The default path's TTFT of one 2000-token prompt alone through four
    512-token chunks (only the last one's sample fetched), one mixed step
    (the B=8 decode step at context 1024 plus one 512-token chunk at
    position 1536; wall around the call and its one fetch, and device time
    by profiler), and the packed and chunked attention ops."""
    runner = engine.runner
    bs, C = runner.block_size, runner.prefill_chunk_tokens
    rng = np.random.default_rng(3)
    vocab = runner.config.vocab_size
    n = 2000
    prompt = rng.integers(0, vocab, n).tolist()
    blocks = list(range(1, (n + bs - 1) // bs + 1))

    def chunked_ttft():
        for s in range(0, n, C):
            out = runner.prefill_chunk(prompt[s:s + C], s, n, blocks, 0.0, 1.0, 0)
        return runner.fetch_sample(out)

    chunked_ttft()  # warm
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        chunked_ttft()
        ts.append((time.perf_counter() - t0) * 1e3)
    dev_ms, prof = profile_calls(torch, chunked_ttft)
    ttft = {"median": statistics.median(ts), "min": min(ts), "max": max(ts),
            "chunks": -(-n // C), "device_ms": dev_ms, "top_kernels": top_kernels(prof, 5)}
    B, ctx = 8, STEP_CTX
    per = (ctx + 1 + bs - 1) // bs
    tables = np.zeros((B, runner.max_blocks_per_seq), np.int32)
    for b in range(B):
        tables[b, :per] = np.arange(1 + b * per, 1 + (b + 1) * per)
    pos = np.full(B, ctx, np.int64)
    slots = tables[np.arange(B), pos // bs].astype(np.int64) * bs + pos % bs
    toks = rng.integers(0, vocab, B)
    zeros, ones, kz = np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int64)
    keys = np.zeros((B, 2), np.int64)
    cprompt = rng.integers(0, vocab, 2048).tolist()
    cblocks = list(range(1 + B * per, 1 + B * per + 2048 // bs))
    chunk = [(cprompt[1536:2048], 1536, 2048, cblocks, 0.0, 1.0, 0, 1.0, None, None, False)]

    def mixed():
        c_outs, d_out = runner.mixed_step(chunk, toks, pos, tables, slots, keys, zeros,
                                          ones, kz)
        return runner.fetch_sample((*c_outs[0], *d_out))

    for _ in range(3):
        mixed()
    ts = []
    for _ in range(10):
        t0 = time.perf_counter()
        mixed()
        ts.append((time.perf_counter() - t0) * 1e3)
    dev_ms, prof = profile_calls(torch, mixed)
    step = {"median": statistics.median(ts), "min": min(ts), "max": max(ts),
            "device_ms": dev_ms, "B": B, "ctx": ctx, "chunk": C, "chunk_start": 1536,
            "decode_attention": per_launch_us(prof, "true"), "top_kernels": top_kernels(prof, 5)}
    flush = make_flush(torch)
    ops = {"chunked_prefill_attention": chunked_row(torch, flush),
           "packed_prefill_attention": packed_row(torch, flush)}
    res = {"ttft_ms_alone_chunked_2000": ttft, "mixed_step_ms_B8_plus_chunk": step,
           "xla_op_ports": ops}
    print(json.dumps({"admission_time": res, "card": card}), flush=True)
    log(f"default path: 2000-token TTFT alone through {ttft['chunks']} chunks "
        f"{ttft['median']:.2f} ms wall / {ttft['device_ms']:.2f} ms device; mixed step "
        f"B=8 + one {C}-token chunk {step['median']:.2f} ms wall / {dev_ms:.2f} ms device")
    for name, row in ops.items():
        yard = row.get("sdpa_pregathered_ms") or row.get("sdpa_masked_ms")
        log(f"{name} (torch op) {row['shape']}: {row['ms']['median']:.4f} ms, bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}), SDPA {yard['median']:.4f} ms")
    return res


# ---------------------------------------------------------------- checkpoint


SAFETENSORS_DTYPES = {"torch.bfloat16": "BF16", "torch.float16": "F16", "torch.float32": "F32"}


def write_safetensors(torch, path: str, tensors: dict) -> None:
    """Write CPU tensors in the safetensors format with the standard library:
    an 8-byte little-endian header length, the JSON header (dtype, shape,
    data_offsets), then each tensor's raw little-endian bytes."""
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_DTYPES[str(t.dtype)], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for t in tensors.values():
            f.write(t.contiguous().view(torch.uint8).numpy().data)


def hf_checkpoint_tensors(torch, params: dict, layers: int) -> dict:
    """The port's parameters under HF Llama names, [out, in] projections
    (transposed on the card), moved to the host."""
    out = {"model.embed_tokens.weight": params["embed"],
           "model.norm.weight": params["final_norm"],
           "lm_head.weight": params["lm_head"].t()}
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
             "wo": "self_attn.o_proj", "wg": "mlp.gate_proj", "wu": "mlp.up_proj",
             "wd": "mlp.down_proj"}
    for i in range(layers):
        layer, p = params["layers"][i], f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = layer["attn_norm"]
        out[p + "post_attention_layernorm.weight"] = layer["mlp_norm"]
        for key, name in names.items():
            out[f"{p}{name}.weight"] = layer[key].t()
    return {k: v.contiguous().cpu() for k, v in out.items()}


CKPT_LAYERS = 2
CKPT_PROMPTS = [(16, 24), (600, 16), (100, 24)]  # (prompt tokens, max tokens)


def phase_checkpoint(torch, np, card: str) -> dict:
    """A 2-layer, full-width bf16 Llama-3.1-8B checkpoint (random weights
    from a seed, norm weights perturbed so that a lost norm shows) written
    with write_safetensors in two shards, loaded through build_torch_engine
    (<dir>); its weights must equal the written ones bit for bit, and its
    greedy tokens an engine's built from the same arrays through params=."""
    import shutil

    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.engine.torch_engine.weights import init_params
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.protocols.common import (
        Context, PreprocessedRequest, SamplingOptions, StopConditions,
    )

    hf = dict(LLAMA31_8B, num_hidden_layers=CKPT_LAYERS)
    cfg = LlamaConfig.from_hf_dict(hf)
    params = init_params(cfg, seed=5, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    norms = [params["final_norm"]] + [
        layer[k] for layer in params["layers"] for k in ("attn_norm", "mlp_norm")]
    for norm in norms:
        norm.add_(0.1 * torch.randn(norm.shape, generator=gen, device="cuda").to(norm.dtype))
    model_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                             "chip_smoke_checkpoint")
    shutil.rmtree(model_dir, ignore_errors=True)
    os.makedirs(model_dir)
    try:
        t0 = time.perf_counter()
        tensors = hf_checkpoint_tensors(torch, params, CKPT_LAYERS)
        names = list(tensors)
        for i in range(2):
            shard = os.path.join(model_dir, f"model-0000{i + 1}-of-00002.safetensors")
            write_safetensors(torch, shard, {n: tensors[n] for n in names[i::2]})
        with open(os.path.join(model_dir, "config.json"), "w") as f:
            json.dump(hf, f)
        nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
        del tensors
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = build_torch_engine(model_dir, device="cuda", max_batch=4, max_model_len=1024)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        same = build_torch_engine(hf, device="cuda", max_batch=4, max_model_len=1024,
                                  params=params)
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    def flat(tree, path=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{path}/{k}").items()}
        if isinstance(tree, list):
            return {k2: v2 for i, v in enumerate(tree) for k2, v2 in flat(v, f"{path}/{i}").items()}
        return {path: tree}

    a, b = flat(loaded.runner.params), flat(params)
    if sorted(a) != sorted(b) or not all(
            a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in b):
        raise SmokeError("checkpoint: the loaded weights differ from the written ones")
    rng = np.random.default_rng(9)
    reqs = [PreprocessedRequest(token_ids=rng.integers(0, cfg.vocab_size, n).tolist(),
                                sampling=SamplingOptions(greedy=True),
                                stop=StopConditions(max_tokens=m), eos_token_ids=[])
            for n, m in CKPT_PROMPTS]

    async def serve(engine):
        try:
            return await run_requests(engine, reqs, Context)
        finally:
            await engine.close()

    got = asyncio.run(serve(loaded))
    want = asyncio.run(serve(same))
    if [t for t, _, _ in got] != [t for t, _, _ in want]:
        raise SmokeError("checkpoint: the loaded engine's tokens differ from params=")
    if [len(t) for t, _, _ in got] != [m for _, m in CKPT_PROMPTS]:
        raise SmokeError("checkpoint: wrong token counts")
    res = {"layers": CKPT_LAYERS, "bytes": nbytes, "write_s": t_write, "load_s": t_load,
           "prompts": CKPT_PROMPTS, "stats": stats_dict(loaded.stats)}
    log(f"checkpoint: {nbytes / 1e9:.2f} GB in 2 shards written in {t_write:.1f} s, loaded "
        f"by build_torch_engine(<dir>) in {t_load:.1f} s; weights bit-identical; greedy "
        f"tokens equal params= over {len(reqs)} requests")
    print(json.dumps({"checkpoint": res, "card": card}), flush=True)
    del loaded, same, params
    gc.collect()
    torch.cuda.empty_cache()
    res["gguf"] = gguf_leg(torch, np, card)
    return res


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def profile_calls(torch, fn, calls: int = 5) -> tuple[float, dict]:
    """Device time of one fn() call -- the CUDA kernels' total under
    torch.profiler over `calls` calls, per call -- and each kernel's
    (total us, launches) over them. Only the device events count: a CPU
    op's entry repeats the time of the kernels it launched. The profiler
    can drop a session's first device record (seen on the H100): a spin
    kernel goes first and is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # device activity alone: the host ops' events would only be read to be
    # dropped, and recording them takes most of a session's time
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(calls):
            fn()
    kernels = {
        e.key: (getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0),
                e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key
    }
    return sum(us for us, _ in kernels.values()) / 1e3 / calls, kernels


def device_ms_per_call(torch, fn, calls: int = 5) -> float:
    return profile_calls(torch, fn, calls)[0]


def host_ms(torch, fn, reps: int = 20) -> float:
    """Median host time of one fn() call (launching, not waiting), each
    call started with the card idle."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def host_ops(torch, fn, calls: int = 3, n: int = 12) -> dict:
    """torch.profiler's CPU self time per op over `calls` fn() calls, per
    call: the total and the n largest ops (name, ms, calls). The profiler's
    own bookkeeping per op inflates these; compare them only with each
    other."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"self_cpu_ms": sum(e.self_cpu_time_total for e in ev) / 1e3 / calls,
            "top": [[e.key, e.self_cpu_time_total / 1e3 / calls, e.count // calls]
                    for e in ev[:n]]}


def per_launch_us(kernels: dict, mode: str, int8: bool = False) -> dict:
    """Per-launch device time of the paged attention template's decode
    (mode "true") or verify ("false") instantiation, bf16 or int8 mode, in a
    profile."""
    us = n = 0
    tag = f", {mode}, {'true' if int8 else 'false'}>"
    for key, (t, c) in kernels.items():
        if "paged_attention_kernel<" in key and tag in key:
            us, n = us + t, n + c
    return {"us_per_launch": us / n if n else None, "launches": n}


# #4's kernels: the one launch of the cluster design, and the earlier
# design's three (norm, split-K product, combine + RoPE epilogue), so
# profiles of either design compare
QKV_KERNELS = ("fused_qkv_rope_kernel", "rmsnorm_rows", "splitk_gemm_kernel", "qkv_epilogue")


def qkv_head_us(kernels: dict, calls: int, layers: int) -> dict:
    """#4's device time per layer in a profile of `calls` steps, summed over
    all its launches, and its launches per layer."""
    us = n = 0
    for key, (t, c) in kernels.items():
        if any(name in key for name in QKV_KERNELS):
            us, n = us + t, n + c
    per = calls * layers
    return {"us_per_layer": us / per if n else None, "launches_per_layer": n / per}


def phase_engine_times(torch, np, engine, fused_runner, card: str) -> dict:
    """TTFT per prompt length (one request alone, prefill + first sample +
    fetch) and the B=8 decode step (model + sampling + fetch), host clock
    around work that ends in a device-to-host copy; the step with the fused
    heads off (`engine`'s runner) and on (`fused_runner`, the same weights),
    off then on, with the device time of each."""
    runner = engine.runner
    bs = runner.block_size
    rng = np.random.default_rng(1)
    vocab = runner.config.vocab_size
    ttft = {}
    for n in (16, 128, 512, 2000):
        prompt = rng.integers(0, vocab, n).tolist()
        blocks = list(range(1, (n + bs - 1) // bs + 1))
        runner.fetch_sample(runner.prefill(prompt, blocks, 0.0, 1.0, 0))  # warm
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            runner.fetch_sample(runner.prefill(prompt, blocks, 0.0, 1.0, 0))
            ts.append((time.perf_counter() - t0) * 1e3)
        ttft[n] = {"median": statistics.median(ts), "min": min(ts), "max": max(ts)}
    # device time of the last (longest) prompt's prefill: all its kernels,
    # by profiler
    ttft[2000]["device_ms"] = device_ms_per_call(
        torch, lambda: runner.fetch_sample(runner.prefill(prompt, blocks, 0.0, 1.0, 0)))
    B, ctx = 8, STEP_CTX
    per = (ctx + 1 + bs - 1) // bs
    tables = np.zeros((B, runner.max_blocks_per_seq), np.int32)
    for b in range(B):
        tables[b, :per] = np.arange(1 + b * per, 1 + (b + 1) * per)
    pos = np.full(B, ctx, np.int64)
    slots = tables[np.arange(B), pos // bs].astype(np.int64) * bs + pos % bs
    toks = rng.integers(0, vocab, B)
    zeros, ones = np.zeros(B, np.float32), np.ones(B, np.float32)
    kz = np.zeros(B, np.int64)

    def step(r):
        return r.fetch_sample(r.decode(toks, pos, tables, slots, zeros, ones, kz))

    runners = {"unfused": runner, "fused": fused_runner}
    walls = {"unfused": [], "fused": []}
    for name in ("unfused", "fused"):
        r = runners[name]
        for _ in range(3):
            step(r)
        for _ in range(10):
            t0 = time.perf_counter()
            step(r)
            walls[name].append((time.perf_counter() - t0) * 1e3)
    decode = {}
    layers = runner.config.num_layers
    for name, r in runners.items():
        ts = walls[name]
        dev_ms, prof = profile_calls(torch, lambda: step(r))
        decode[name] = {
            "median": statistics.median(ts), "min": min(ts), "max": max(ts),
            "device_ms": dev_ms, "B": B, "ctx": ctx,
            "decode_attention": per_launch_us(prof, "true"),
            "qkv_head": qkv_head_us(prof, 5, layers),
        }
    # one B=8, S=4 fused verify dispatch at the same context: each lane
    # re-feeds its token at position 1024 and scores 3 drafts after it
    drafts = rng.integers(0, vocab, (B, 3))
    many = np.full(B, 1 << 20, np.int64)

    def verify():
        return fused_runner.spec_verify(
            3, 0, toks, drafts, np.full(B, 3), pos, tables, zeros, ones, kz,
            np.zeros((B, 2), np.int64), np.ones(B, bool), many).cpu()

    verify()
    dev_ms, prof = profile_calls(torch, verify)
    verify_step = {"device_ms": dev_ms, "B": B, "S": 4, "ctx": ctx,
                   "verify_attention": per_launch_us(prof, "false"),
                   "qkv_head": qkv_head_us(prof, 5, layers)}
    res = {
        "ttft_ms_alone": ttft, "decode_step_ms_B8": decode, "verify_dispatch_B8_S4": verify_step,
        "decode_output_tok_per_s_B8": {k: B / (v["median"] / 1e3) for k, v in decode.items()},
    }
    print(json.dumps({"engine_time": res, "card": card}), flush=True)
    log("TTFT alone: " + "; ".join(f"{n} tokens {v['median']:.2f} ms" for n, v in ttft.items())
        + f"; 2000-token prefill device time {ttft[2000]['device_ms']:.2f} ms")
    log(f"decode step B=8 ctx 1024: unfused {decode['unfused']['median']:.2f} ms wall / "
        f"{decode['unfused']['device_ms']:.2f} ms device; fused "
        f"{decode['fused']['median']:.2f} ms wall / {decode['fused']['device_ms']:.2f} ms device; "
        f"decode attention per launch: unfused "
        f"{decode['unfused']['decode_attention']['us_per_launch']} us, fused "
        f"{decode['fused']['decode_attention']['us_per_launch']} us; fused QKV head (#4) "
        f"{decode['fused']['qkv_head']['us_per_layer']} us per layer in "
        f"{decode['fused']['qkv_head']['launches_per_layer']} launch(es)")
    log(f"verify dispatch B=8 S=4 ctx 1024: {verify_step['device_ms']:.3f} ms device; "
        f"verify attention {verify_step['verify_attention']['us_per_launch']} us per launch; "
        f"fused QKV head (#4) {verify_step['qkv_head']['us_per_layer']} us per layer")
    return res


# ------------------------------------------------------------------- int8
#
# The JAX package's int8 deployment (DYN_JAX_QUANTIZE_INT8=1,
# DYN_KV_DTYPE=int8): int8 weight-only dense projections and an
# int8-resident paged KV cache, through the int8 modes of #1, #2, #4, #5.

INT8_KERNELS = ("paged_decode_attention_int8", "paged_verify_attention_int8",
                "fused_qkv_rope_int8", "fused_attn_out_residual_int8")
# the int8 engine's dense reference attends the unquantized K/V of the same
# int8 weights, so its logits carry the cache's quantization noise on top of
# bf16's: the engine's greedy token must lie within this of the best. The
# largest gap read on an H100 80GB HBM3 was 0.125 (the spec leg); the bf16
# engines read 0.031-0.062 against reference_check's default bound of 0.25
INT8_REF_GAP = 0.5


def int8_pages(torch, cache):
    """A bf16 cache [Hkv, nb, bs, D] quantized the way the engine's
    prefill writes it (each (head, page)'s exact absmax, so every page has
    its own scale): (int8 mantissas, f32 scales [Hkv, nb])."""
    from dynamo_tpu_torch.ops import kv_quant

    layer = kv_quant.make_cache(tuple(cache.shape), cache.dtype, quantized=True,
                                device=cache.device)
    kv_quant.write_blocks_quant(layer, cache, torch.arange(cache.shape[1], device=cache.device))
    return layer["q"], layer["s"]


def int8_weights(t: dict) -> dict:
    """gemv_inputs' weights quantized as the engine quantizes them."""
    from dynamo_tpu_torch.ops.linear import quantize_int8

    return dict(t, **{k: quantize_int8(t[k]) for k in ("wq", "wk", "wv", "wo")})


def phase_parity_int8(torch) -> dict:
    """Each int8 mode against its plain version on the same int8 inputs:
    #1q / #2q at Llama-3.1-8B, Qwen2-7B (G 7) and Gemma-2-9B (D 256) heads
    with the window and scale / softcap cases, contexts that cross pages
    (each page its own scale), at DECODE_TOL; #4q at those widths and #5q
    at Llama width, M = 8 and 32, at GEMV_TOL."""
    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops import cuda_attention as K
    from dynamo_tpu_torch.ops import cuda_linear as KL
    from dynamo_tpu_torch.ops import linear as L

    errs = dict.fromkeys(INT8_KERNELS, 0.0)

    def check(kernel, label, got, want, tol):
        torch.cuda.synchronize()
        e = compare(torch, label, got, want, tol)
        errs[kernel] = max(errs[kernel], e)
        log(f"parity {label}: max|d|={e:.3e} (tol {tol[0]:g} + {tol[1]:g}|x|)")

    shapes = {"llama31_8b": (HQ, HKV, D, HIDDEN), **HEAD_SHAPES}
    for name, (hq, hkv, d, hidden) in shapes.items():
        shp = dict(hq=hq, hkv=hkv, d=d)
        tag = f"{name} Hq={hq} Hkv={hkv} D={d}"
        q, k, v, tables, lens = decode_inputs(torch, DECODE_LENS, seed=60, **shp)
        (kq, ks), (vq, vs) = int8_pages(torch, k), int8_pages(torch, v)
        del k, v
        for case, kw in DECODE_CASES:
            check("paged_decode_attention_int8", f"int8 decode/{case} {tag}",
                  K.paged_decode_attention_int8_cuda(q, kq, vq, tables, lens, ks, vs, **kw),
                  A.paged_decode_attention_plain(q, kq, vq, tables, lens, k_scales=ks,
                                                 v_scales=vs, **kw), DECODE_TOL)
        q, k, v, tables, pos = verify_inputs(torch, VERIFY_BASES, VERIFY_DRAFT_LENS, VERIFY_S,
                                             seed=61, **shp)
        (kq, ks), (vq, vs) = int8_pages(torch, k), int8_pages(torch, v)
        del k, v
        for case, kw in DECODE_CASES:
            check("paged_verify_attention_int8", f"int8 verify/{case} {tag}",
                  K.paged_verify_attention_int8_cuda(q, kq, vq, tables, pos, ks, vs, **kw),
                  A.paged_verify_attention_plain(q, kq, vq, tables, pos, k_scales=ks,
                                                 v_scales=vs, **kw), DECODE_TOL)
        for M in (8, 32):
            t = int8_weights(gemv_inputs(torch, M, seed=70 + M, bias=name == "qwen2_7b",
                                         hidden=hidden, **shp))
            got = qkv_call(KL.fused_qkv_rope_int8_cuda, t)
            want = qkv_call(L.fused_qkv_rope_plain, t)
            for n, a, b in zip("qkv", got, want):
                check("fused_qkv_rope_int8", f"int8 qkv/M{M}/{n} {tag} hidden={hidden}", a, b,
                      GEMV_TOL)
            if name == "llama31_8b":
                check("fused_attn_out_residual_int8", f"int8 out/M{M} {tag}",
                      KL.fused_attn_out_residual_int8_cuda(t["attn"], t["wo"], t["x"]),
                      L.fused_attn_out_residual_plain(t["attn"], t["wo"], t["x"]), GEMV_TOL)
    return errs


def dequantized(torch, pages, scales):
    """bf16 K / V from int8 pages (what the library call is given: the
    dequantization is not timed)."""
    return (pages.float() * scales[..., None, None]).to(torch.bfloat16)


def int8_attention_times(torch, flush) -> dict:
    """#1q at chip_smoke's ragged contexts and at the B=8 step's shape, and
    #2q at the verify shape: kernel, plain, and SDPA over the same keys
    gathered and dequantized to bf16 beforehand (not timed)."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops import cuda_attention as K

    rows = {}
    for name, lens in (("paged_decode_attention_int8", DECODE_LENS),
                       ("paged_decode_attention_int8/step", [STEP_CTX + 1] * 8)):
        q, k, v, tables, lens_t = decode_inputs(torch, lens, seed=62)
        (kq, ks), (vq, vs) = int8_pages(torch, k), int8_pages(torch, v)
        kd, vd = dequantized(torch, kq, ks), dequantized(torch, vq, vs)
        del k, v
        t_k = time_ms(torch, lambda: K.paged_decode_attention_int8_cuda(
            q, kq, vq, tables, lens_t, ks, vs), flush=flush)
        t_p = time_ms(torch, lambda: A.paged_decode_attention_plain(
            q, kq, vq, tables, lens_t, k_scales=ks, v_scales=vs), reps=5, flush=flush)
        B, S = len(lens), max(lens)
        kg = torch.zeros(B, HKV, S, D, dtype=torch.bfloat16, device="cuda")
        vg = torch.zeros_like(kg)
        for b, n in enumerate(lens):
            pages = tables[b, : (n + BLOCK - 1) // BLOCK].long()
            kg[b, :, :n] = kd[:, pages].reshape(HKV, -1, D)[:, :n]
            vg[b, :, :n] = vd[:, pages].reshape(HKV, -1, D)[:, :n]
        mask = (torch.arange(S, device="cuda")[None, :] < lens_t[:, None].long())[:, None, None, :]
        qd = q[:, :, None, :]
        t_s = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qd, kg, vg, attn_mask=mask, enable_gqa=True), flush=flush)
        b_ms, b_by, nbytes, flops = decode_bound(lens, B, kv_bytes=1)
        rows[name] = {
            "ms": t_k, "plain_ms": t_p, "library_ms": t_s, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops,
            "library": "SDPA over the keys gathered and dequantized to bf16 beforehand, "
                       "length mask, enable_gqa",
            "shape": f"B={B} Hq={HQ} Hkv={HKV} D={D} block={BLOCK} int8 pages, lens "
                     f"{lens if len(set(lens)) > 1 else f'{B} x {lens[0]}'}",
        }
    S_, bases = VERIFY_S, VERIFY_BASES
    q, k, v, tables, pos = verify_inputs(torch, bases, [S_ - 1] * len(bases), S_, seed=63)
    (kq, ks), (vq, vs) = int8_pages(torch, k), int8_pages(torch, v)
    kd, vd = dequantized(torch, kq, ks), dequantized(torch, vq, vs)
    del k, v
    t_k = time_ms(torch, lambda: K.paged_verify_attention_int8_cuda(
        q, kq, vq, tables, pos, ks, vs), flush=flush)
    t_p = time_ms(torch, lambda: A.paged_verify_attention_plain(
        q, kq, vq, tables, pos, k_scales=ks, v_scales=vs), reps=5, flush=flush)
    ctx = max(bases) + S_
    kg = torch.zeros(len(bases), HKV, ctx, D, dtype=torch.bfloat16, device="cuda")
    vg = torch.zeros_like(kg)
    for b, p in enumerate(bases):
        n = p + S_
        pages = tables[b, : (n + BLOCK - 1) // BLOCK].long()
        kg[b, :, :n] = kd[:, pages].reshape(HKV, -1, D)[:, :n]
        vg[b, :, :n] = vd[:, pages].reshape(HKV, -1, D)[:, :n]
    mask = torch.arange(ctx, device="cuda")[None, None, :] <= pos.long()[:, :, None]
    t_s = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), kg, vg, attn_mask=mask[:, None], enable_gqa=True), flush=flush)
    b_ms, b_by, nbytes, flops = verify_bound(bases, S_, kv_bytes=1)
    rows["paged_verify_attention_int8"] = {
        "ms": t_k, "plain_ms": t_p, "library_ms": t_s, "bound_ms": b_ms, "bound_by": b_by,
        "bytes": nbytes, "flops": flops,
        "library": "SDPA over keys gathered and dequantized to bf16 beforehand, causal mask",
        "shape": f"B={len(bases)} S={S_} Hq={HQ} Hkv={HKV} D={D} block={BLOCK} int8 pages",
    }
    return rows


def int8_gemv_times(torch, flush) -> dict:
    """#4q and #5q at M = 8 (a decode step) and 32 (a verify step):
    kernel, plain, and the product alone over weights dequantized to bf16
    beforehand (matmul of pre-normed rows; addmm with the residual)."""
    from dynamo_tpu_torch.ops import cuda_linear as KL
    from dynamo_tpu_torch.ops import linear as L
    from dynamo_tpu_torch.ops.basics import rms_norm

    rows = {}
    eps = LLAMA31_8B["rms_norm_eps"]
    for M in (8, 32):
        t = int8_weights(gemv_inputs(torch, M, seed=80 + M))
        deq = {k: (t[k]["q"].float() * t[k]["s"].float()).to(torch.bfloat16)
               for k in ("wq", "wk", "wv", "wo")}
        wqkv = torch.cat([deq["wq"], deq["wk"], deq["wv"]], dim=1)
        xn = rms_norm(t["x"], t["norm"], eps)
        N = (HQ + 2 * HKV) * D
        t_k = time_ms(torch, lambda: qkv_call(KL.fused_qkv_rope_int8_cuda, t), flush=flush)
        t_p = time_ms(torch, lambda: qkv_call(L.fused_qkv_rope_plain, t), flush=flush)
        t_m = time_ms(torch, lambda: torch.matmul(xn, wqkv), flush=flush)
        b_ms, b_by, nbytes, flops = gemv_bound(M, HIDDEN, N, HIDDEN * 2 + M * D * 4, w_bytes=1)
        rows[f"fused_qkv_rope_int8/M{M}"] = {
            "ms": t_k, "plain_ms": t_p, "library_ms": t_m, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops, "ratio_to_library": t_k["median"] / t_m["median"],
            "library": "torch.matmul(xn, [wq|wk|wv]) over a pre-normed x and the weights "
                       "dequantized to bf16 beforehand: the product alone, 2 bytes a weight",
            "shape": f"M={M} hidden={HIDDEN} N={N} int8 weights",
        }
        t_k = time_ms(torch, lambda: KL.fused_attn_out_residual_int8_cuda(t["attn"], t["wo"], t["x"]),
                      flush=flush)
        t_p = time_ms(torch, lambda: L.fused_attn_out_residual_plain(t["attn"], t["wo"], t["x"]),
                      flush=flush)
        t_s = time_ms(torch, lambda: torch.addmm(t["x"], t["attn"], deq["wo"]), flush=flush)
        b_ms, b_by, nbytes, flops = gemv_bound(M, HQ * D, HIDDEN, M * HIDDEN * 2, w_bytes=1)
        rows[f"fused_attn_out_residual_int8/M{M}"] = {
            "ms": t_k, "plain_ms": t_p, "library_ms": t_s, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops, "ratio_to_library": t_k["median"] / t_s["median"],
            "library": "torch.addmm(x, attn, wo) over wo dequantized to bf16 beforehand",
            "shape": f"M={M} K={HQ * D} N={HIDDEN} int8 weights",
        }
    return rows


def phase_kernel_times_int8(torch, card: str) -> dict:
    flush = make_flush(torch)
    rows = {**int8_attention_times(torch, flush), **int8_gemv_times(torch, flush)}
    for name, row in rows.items():
        print(json.dumps({"kernel_time": name, "card": card, **row}), flush=True)
        log(f"{name} {row['shape']}: {row['ms']['median']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}), plain {row['plain_ms']['median']:.4f} ms, library "
            f"{row['library_ms']['median']:.4f} ms ({card})")
    return rows


def phase_serve_int8(torch, np, card: str, bf16_blocks: int, bf16_peak: int) -> dict:
    """The int8 deployment: build_torch_engine(quantize=True,
    kv_dtype="int8", fused_decode=True) at Llama-3.1-8B width on the
    default admission path (seed 0: the serve phase's bf16 draws,
    quantized), the serve phase's 8 requests; then an engine on the same
    weights built from the JAX factory's variables (DYN_JAX_QUANTIZE_INT8,
    DYN_KV_DTYPE, DYN_FUSED_DECODE, DYN_SPEC_K=3) over quoting traffic.
    The counters are set to 0 just before each run and read just after."""
    from dynamo_tpu_torch.engine.torch_engine.factory import (
        build_torch_engine, default_num_blocks, device_memory_bytes,
    )
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.ops import kernels
    from dynamo_tpu_torch.protocols.common import (
        Context, FinishReason, PreprocessedRequest, SamplingOptions, StopConditions,
    )

    t0 = time.perf_counter()
    # the earlier phases' engines are still on the card: the int8 engine's
    # own peak is the peak above what they hold
    mem_before = torch.cuda.memory_allocated()
    engine = build_torch_engine(
        MAIN_MODEL, device="cuda", max_batch=8, max_model_len=MAX_MODEL_LEN, seed=0,
        quantize=True, kv_dtype="int8", fused_decode=True, spec_k=0, **EAGER,
    )
    torch.cuda.synchronize()
    runner = engine.runner
    build_s = time.perf_counter() - t0
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(runner.params))
    if not runner.kv_quantized or runner.prefill_chunk_tokens != 512 or not engine._mixed_enabled:
        raise SmokeError("serve_int8: not the int8 cache on the default admission path")
    # the JAX factory's sizing: every lane at full context (+64) fits both
    # forms on this card; what the budget would hold shows in the caps
    cfg = LlamaConfig.from_hf_dict(MAIN_MODEL)
    budget = device_memory_bytes(runner.device)
    caps = {kv: default_num_blocks(cfg, 131072, 512, budget_bytes=budget,
                                   quantized=kv == "int8", kv_dtype=kv)
            for kv in ("bf16", "int8")}
    want_blocks = default_num_blocks(cfg, MAX_MODEL_LEN, 8, budget_bytes=budget, quantized=True,
                                     kv_dtype="int8")
    if runner.num_blocks != want_blocks:
        raise SmokeError(f"serve_int8: {runner.num_blocks} blocks, the sizing says {want_blocks}")
    log(f"serve_int8: engine built in {build_s:.1f} s; int8 weights {wbytes / 1e9:.2f} GB, KV "
        f"pool {runner.num_blocks} blocks ({runner.kv_cache_bytes / 1e9:.3f} GB; bf16 engine "
        f"{bf16_blocks} blocks); blocks the budget would hold at 512 x 131072 tokens: bf16 "
        f"{caps['bf16']}, int8 {caps['int8']}")
    reqs = make_requests(np, PreprocessedRequest, SamplingOptions, StopConditions)
    spec_env = {"DYN_JAX_QUANTIZE_INT8": "1", "DYN_KV_DTYPE": "int8", "DYN_FUSED_DECODE": "1",
                "DYN_SPEC_K": str(SPEC_K)}

    async def serve():
        try:
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            first = await run_requests(engine, reqs, Context)
            wall = time.perf_counter() - t1
            stats = stats_dict(engine.stats)
            launches = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            t1 = time.perf_counter()
            second = await run_requests(engine, reqs, Context)
            wall_warm = time.perf_counter() - t1
            # the spec leg: the JAX factory's variables, the same weights
            saved = {k: os.environ.get(k) for k in spec_env}
            os.environ.update(spec_env)
            try:
                spec = build_torch_engine(MAIN_MODEL, device="cuda", max_batch=8,
                                          max_model_len=MAX_MODEL_LEN, seed=0,
                                          params=runner.params, spec_min_coverage=SPEC_COVERAGE,
                                          **EAGER)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            try:
                if not (spec.runner.kv_quantized and spec.config.spec_k == SPEC_K
                        and spec.runner.config.fused_decode):
                    raise SmokeError("serve_int8: the variables did not build the int8 spec engine")
                sreqs = await repeating_prompts(np, engine, PreprocessedRequest, SamplingOptions,
                                                StopConditions, Context)
                kernels.reset_launch_counts()
                t1 = time.perf_counter()
                sfirst = await run_requests(spec, sreqs, Context)
                swall = time.perf_counter() - t1
                sstats = stats_dict(spec.stats)
                slaunches = kernels.launch_counts()
            finally:
                await spec.close()
            return (first, second, wall, wall_warm, stats, launches, peak, sreqs, sfirst, swall,
                    sstats, slaunches, spec.runner)
        finally:
            await engine.close()

    (first, second, wall, wall_warm, stats, launches, peak, sreqs, sfirst, swall, sstats,
     slaunches, spec_runner) = asyncio.run(serve())
    vocab = LLAMA31_8B["vocab_size"]
    for i, ((toks, reason, _), req) in enumerate(zip(first, reqs)):
        if i == PENALIZED:
            ok = len(toks) >= MIN_TOKENS and reason in (FinishReason.LENGTH, FinishReason.EOS)
        else:
            ok = reason is FinishReason.LENGTH and len(toks) == req.stop.max_tokens
        if not ok or not all(0 <= t < vocab for t in toks):
            raise SmokeError(f"serve_int8 request {i}: {len(toks)} tokens, reason {reason}")
        if second[i][0] != toks:
            raise SmokeError(f"serve_int8 request {i}: the repeated run gave other tokens")
    for i, (toks, reason, _) in enumerate(sfirst):
        if reason is not FinishReason.LENGTH or len(toks) != SPEC_MAX_TOKENS:
            raise SmokeError(f"serve_int8 spec request {i}: {len(toks)} tokens, reason {reason}")
    if stats["mixed_steps"] <= 0 or stats["packed_prefills"] <= 0 or stats["prefills"]:
        raise SmokeError(f"serve_int8: did not pack and mix: {stats}")
    if sstats["verify_steps"] <= 0:
        raise SmokeError(f"serve_int8: no verify dispatch on the spec leg: {sstats}")
    L = runner.config.num_layers
    steps = stats["decode_steps"] + stats["mixed_steps"]
    want = {**dict.fromkeys(kernels.KERNELS, 0), "paged_decode_attention_int8": L * steps,
            "fused_qkv_rope_int8": L * steps, "fused_attn_out_residual_int8": L * steps}
    if launches != want:
        raise SmokeError(f"serve_int8: kernel launches {launches} != {want}")
    ssteps = sstats["decode_steps"] + sstats["mixed_steps"]
    verify = sstats["verify_steps"]
    swant = {**dict.fromkeys(kernels.KERNELS, 0), "paged_decode_attention_int8": L * ssteps,
             "paged_verify_attention_int8": L * verify,
             "fused_qkv_rope_int8": L * (ssteps + verify),
             "fused_attn_out_residual_int8": L * (ssteps + verify)}
    if slaunches != swant:
        raise SmokeError(f"serve_int8 spec: kernel launches {slaunches} != {swant}")
    # every int8 counter moved, no bf16 one, over the two runs
    both = {k: launches[k] + slaunches[k] for k in kernels.KERNELS}
    if any(both[k] == 0 for k in INT8_KERNELS) or any(
            both[k] for k in kernels.KERNELS if k not in INT8_KERNELS):
        raise SmokeError(f"serve_int8: launches {both}")
    gap = max(reference_check(torch, runner, reqs[i].token_ids, first[i][0], bound=INT8_REF_GAP)
              for i in (0, -1))
    sgap = max(reference_check(torch, spec_runner, sreqs[i].token_ids, sfirst[i][0], n_check=32,
                               bound=INT8_REF_GAP)
               for i in range(len(sreqs)) if i != SAMPLED)
    out_tokens = sum(len(t) for t, _, _ in first)
    res = {
        "requests": len(reqs), "prompt_lens": PROMPT_LENS, "stats": stats, "launches": launches,
        "wall_s": wall, "wall_s_warm": wall_warm, "output_tok_per_s_warm": out_tokens / wall_warm,
        "ttft_s_concurrent": [t for _, _, t in first],
        "ttft_s_concurrent_warm": [t for _, _, t in second],
        "engine_peak_mem_bytes": peak - mem_before, "engine_peak_mem_bytes_bf16_serve": bf16_peak,
        "weight_bytes": wbytes, "kv_cache_bytes": runner.kv_cache_bytes,
        "num_blocks": runner.num_blocks, "num_blocks_bf16": bf16_blocks,
        "block_caps_512x131072": caps, "build_s": build_s,
        "reference_max_logit_gap": gap, "reference_bound": INT8_REF_GAP,
        "spec": {"prompt_lens": [len(r.token_ids) for r in sreqs], "stats": sstats,
                 "launches": slaunches, "wall_s": swall,
                 "acceptance": sstats["num_accepted_tokens"] / max(1, sstats["num_draft_tokens"]),
                 "reference_max_logit_gap_32": sgap},
    }
    log(f"serve_int8: {len(reqs)} requests ({out_tokens} tokens) in {wall:.2f} s ({wall_warm:.2f} s "
        f"warm); {stats['packed_prefills']} packed prefills, {stats['mixed_steps']} mixed steps, "
        f"{stats['decode_steps']} decode steps; launches {launches}; repeat identical; reference "
        f"gap {gap:.3f} (bound {INT8_REF_GAP}); the engine's peak memory {(peak - mem_before) / 1e9:.2f}"
        f" GB (bf16 serve engine {bf16_peak / 1e9:.2f} GB)")
    log(f"serve_int8 spec (DYN_* variables): {verify} verify dispatches, {ssteps} decode steps; "
        f"drafts {sstats['num_drafts']}, accepted {sstats['num_accepted_tokens']}; launches "
        f"{slaunches}; reference gap over 32 tokens {sgap:.3f}")
    print(json.dumps({"serve_int8": res, "card": card}), flush=True)
    res["runner"] = runner
    res["launches_both"] = both
    return res


def int8_engine_times(torch, np, int8_runner, bf16_runner, bf16_chunked_runner,
                      card: str) -> dict:
    """The int8 deployment's step and TTFT beside bf16's, same card, in
    turns: the B=8 fused decode step at context 1024 (wall and device time,
    #1q per launch, #4q per layer), the 2000-token TTFT alone through four
    512-token chunks on the default path, and the unfused int8 linear op's
    share of the int8 step (the MLP's three products per layer and lm_head,
    CUDA-event times at M = 8, beside the same products in bf16)."""
    from dynamo_tpu_torch.ops import kv_quant
    from dynamo_tpu_torch.ops.attention import write_decode_kv
    from dynamo_tpu_torch.ops.linear import linear

    rng = np.random.default_rng(11)
    vocab = int8_runner.config.vocab_size
    bs = int8_runner.block_size
    B, ctx = 8, STEP_CTX
    per = (ctx + 1 + bs - 1) // bs
    tables = np.zeros((B, int8_runner.max_blocks_per_seq), np.int32)
    for b in range(B):
        tables[b, :per] = np.arange(1 + b * per, 1 + (b + 1) * per)
    pos = np.full(B, ctx, np.int64)
    slots = tables[np.arange(B), pos // bs].astype(np.int64) * bs + pos % bs
    toks = rng.integers(0, vocab, B)
    zeros, ones, kz = np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int64)

    def step(r):
        return r.fetch_sample(r.decode(toks, pos, tables, slots, zeros, ones, kz))

    runners = {"bf16": bf16_runner, "int8": int8_runner}
    walls = {"bf16": [], "int8": []}
    for name in ("bf16", "int8"):
        r = runners[name]
        for _ in range(3):
            step(r)
        for _ in range(10):
            t0 = time.perf_counter()
            step(r)
            walls[name].append((time.perf_counter() - t0) * 1e3)
    layers = int8_runner.config.num_layers
    decode = {}
    for name, r in runners.items():
        dev_ms, prof = profile_calls(torch, lambda: step(r))
        decode[name] = {
            "median": statistics.median(walls[name]), "min": min(walls[name]),
            "max": max(walls[name]), "device_ms": dev_ms, "B": B, "ctx": ctx,
            "decode_attention": per_launch_us(prof, "true", int8=name == "int8"),
            "qkv_head": qkv_head_us(prof, 5, layers), "top_kernels": top_kernels(prof, 5),
        }
    # TTFT of one 2000-token prompt alone through four chunks, in turns
    n = 2000
    prompt = rng.integers(0, vocab, n).tolist()
    blocks = list(range(1, (n + bs - 1) // bs + 1))

    def chunked_ttft(r):
        C = r.prefill_chunk_tokens
        for s in range(0, n, C):
            out = r.prefill_chunk(prompt[s:s + C], s, n, blocks, 0.0, 1.0, 0)
        return r.fetch_sample(out)

    # the default path's runners (the fused bf16 one does not chunk)
    chunkers = {"bf16": bf16_chunked_runner, "int8": int8_runner}
    ttft = {"bf16": [], "int8": []}
    for name in ("bf16", "int8"):
        chunked_ttft(chunkers[name])
        for _ in range(3):
            t0 = time.perf_counter()
            chunked_ttft(chunkers[name])
            ttft[name].append((time.perf_counter() - t0) * 1e3)
    ttft = {k: {"median": statistics.median(v), "min": min(v), "max": max(v),
                "device_ms": device_ms_per_call(torch, lambda: chunked_ttft(chunkers[k]), calls=2)}
            for k, v in ttft.items()}
    # the unfused products of one step: the MLP's three per layer and lm_head
    flush = make_flush(torch)
    share = {}
    for name, r in runners.items():
        lay, p = r.params["layers"][0], r.params
        h = torch.randn(B, HIDDEN, device="cuda").to(torch.bfloat16)
        a = torch.randn(B, LLAMA31_8B["intermediate_size"], device="cuda").to(torch.bfloat16)
        t_mlp = sum(time_ms(torch, lambda w=lay[k], x=x: linear(x, w), flush=flush)["median"]
                    for k, x in (("wg", h), ("wu", h), ("wd", a)))
        t_head = time_ms(torch, lambda: linear(h, p["lm_head"]), flush=flush)["median"]
        total = layers * t_mlp + t_head
        share[name] = {"mlp_ms_per_layer": t_mlp, "lm_head_ms": t_head, "step_ms": total,
                       "share_of_step_device": total / decode[name]["device_ms"]}
    # where the step's host time goes: the CPU self time per op over a whole
    # step, then the host time of one call of the step's cache write (one
    # layer's K and V, 32 calls a step) and of the unfused products
    # (3 x 32 MLP products and lm_head), each alone
    host = {}
    for name, r in runners.items():
        lay, p = r.params["layers"][0], r.params
        h = torch.randn(B, HIDDEN, device="cuda").to(torch.bfloat16)
        a = torch.randn(B, LLAMA31_8B["intermediate_size"], device="cuda").to(torch.bfloat16)
        kv = torch.randn(B, r.config.num_kv_heads, r.config.head_dim, device="cuda").to(torch.bfloat16)
        sl = torch.from_numpy(slots).cuda()
        kl, vl = kv_quant.cache_layer(r.k_cache, 0), kv_quant.cache_layer(r.v_cache, 0)
        w_ms = host_ms(torch, lambda: write_decode_kv(kl, vl, kv, kv, sl))
        mlp_ms = sum(host_ms(torch, lambda w=lay[k], x=x: linear(x, w))
                     for k, x in (("wg", h), ("wu", h), ("wd", a)))
        head_ms = host_ms(torch, lambda: linear(h, p["lm_head"]))
        step_host = host_ms(torch, lambda: r.decode(toks, pos, tables, slots, zeros, ones, kz), reps=5)
        host[name] = {"step_launch_ms": step_host, "write_ms_per_layer": w_ms,
                      "write_ms_per_step": layers * w_ms, "mlp_linear_ms_per_layer": mlp_ms,
                      "lm_head_ms": head_ms, "linear_ms_per_step": layers * mlp_ms + head_ms,
                      "profile": host_ops(torch, lambda: step(r))}
    res = {"decode_step_ms_B8_fused": decode, "ttft_ms_alone_chunked_2000": ttft,
           "unfused_linear": share, "host_ms": host}
    print(json.dumps({"engine_time_int8": res, "card": card}), flush=True)
    log(f"int8 vs bf16, fused B=8 step at 1024: wall {decode['int8']['median']:.2f} / "
        f"{decode['bf16']['median']:.2f} ms, device {decode['int8']['device_ms']:.2f} / "
        f"{decode['bf16']['device_ms']:.2f} ms; #1 per launch "
        f"{decode['int8']['decode_attention']['us_per_launch']} / "
        f"{decode['bf16']['decode_attention']['us_per_launch']} us; #4 per layer "
        f"{decode['int8']['qkv_head']['us_per_layer']} / {decode['bf16']['qkv_head']['us_per_layer']} us")
    log(f"int8 vs bf16, 2000-token TTFT through 4 chunks: {ttft['int8']['median']:.2f} / "
        f"{ttft['bf16']['median']:.2f} ms wall, {ttft['int8']['device_ms']:.2f} / "
        f"{ttft['bf16']['device_ms']:.2f} ms device; the unfused products (MLP x 32 + lm_head) "
        f"{share['int8']['step_ms']:.2f} / {share['bf16']['step_ms']:.2f} ms, "
        f"{100 * share['int8']['share_of_step_device']:.1f}% / "
        f"{100 * share['bf16']['share_of_step_device']:.1f}% of the step's device time ({card})")
    log(f"int8 vs bf16, host ms of the B=8 fused step: launch {host['int8']['step_launch_ms']:.2f} / "
        f"{host['bf16']['step_launch_ms']:.2f}; cache writes {host['int8']['write_ms_per_step']:.2f} / "
        f"{host['bf16']['write_ms_per_step']:.2f}; unfused products "
        f"{host['int8']['linear_ms_per_step']:.2f} / {host['bf16']['linear_ms_per_step']:.2f} ({card})")
    return res


# ------------------------------------------------------------ tensor parallel

# #5's partial_out mode (the tensor-parallel o-projection) counts under
# these names; both are entry points of #5's source
TP_KERNELS = ("fused_attn_out_partial", "fused_attn_out_partial_int8")
# the raw f32 partial has no bf16 cast, so only the split-K summation order
# differs from the plain version: |d| <= 1e-3 + 2^-10 |plain|
PARTIAL_TOL = (1e-3, 2.0 ** -10)
# per-rank shapes (K, N, row stride, first column): Llama-3.1-8B tp=2's o-proj
# shard, one ring chunk of it (a strided column slice), Llama-3.1-70B tp=8's
PARTIAL_SHAPES = {
    "llama31_8b_tp2": (HQ * D // 2, HIDDEN, HIDDEN, 0),
    "llama31_8b_tp2_ring_chunk": (HQ * D // 2, HIDDEN // 2, HIDDEN, HIDDEN // 2),
    "llama31_70b_tp8": (64 * D // 8, 8192, 8192, 0),
}
TP = 2
# serve_tp runs Llama-3.1-8B's width at 4 of its 32 layers (its legs'
# checks hold at any depth; PERF.md keeps the 32-layer rows): 8 until the
# multimodal slice cut it to make room for its own legs
TP_MODEL = dict(LLAMA31_8B, num_hidden_layers=4)
TP_BLOCKS = 2112  # per rank: two ranks share the card, so the pool is set here
TP_REQUESTS = (0, 2, 4, 7)  # serve's 16-, 300-, 800- and 2000-token prompts
TP_TIER_GB = "4"  # DYN_KV_HOST_OFFLOAD_GB of the tp = 2 group's tiers leg
# the tp=2 engine's first decode step against the one-card engine's on the
# same weights: every row within 2^-4 of that row's largest |logit| (each
# of 32 layers rounds the bf16 residual stream in other places: prefill
# sums the ranks' f32 partials before the one cast where one card casts a
# bf16 product, and the sums run in another order; int8 adds the per-block
# KV scales, which follow the values written)
TP_LOGIT_TOL = 2.0 ** -4


def partial_inputs(torch, M: int, K: int, N: int, ldw: int, col: int, seed: int):
    """attn [M, K] bf16 and a [K, N] column slice (first column ``col``) of
    a [K, ldw] bf16 weight and of its int8 mantissas."""
    from dynamo_tpu_torch.ops.linear import quantize_int8

    g = torch.Generator(device="cuda").manual_seed(seed)
    attn = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
    full = (torch.randn(K, ldw, generator=g, device="cuda") / K ** 0.5).to(torch.bfloat16)
    return attn, full[:, col:col + N], quantize_int8(full)["q"][:, col:col + N]


def phase_parity_tp(torch) -> dict:
    """5p and 5pq against their plain version on the card at the per-rank
    shapes of PARTIAL_SHAPES, M = 8 and 32, at PARTIAL_TOL (main() runs
    ``parallel_parity`` beside the parity phase)."""
    from dynamo_tpu_torch.ops import cuda_linear as KL
    from dynamo_tpu_torch.ops import linear as L

    errs = dict.fromkeys(TP_KERNELS, 0.0)
    for shape, (K, N, ldw, col) in PARTIAL_SHAPES.items():
        for M in (8, 32):
            attn, w, q8 = partial_inputs(torch, M, K, N, ldw, col, seed=90 + M + K // 64)
            for name, fn, ww in ((TP_KERNELS[0], KL.fused_attn_out_partial_cuda, w),
                                 (TP_KERNELS[1], KL.fused_attn_out_partial_int8_cuda, q8)):
                got = fn(attn, ww)
                torch.cuda.synchronize()
                e = compare(torch, f"{name}/{shape}/M{M}", got,
                            L.fused_attn_out_partial_plain(attn, ww), PARTIAL_TOL)
                errs[name] = max(errs[name], e)
                log(f"parity {name} {shape} M={M} K={K} N={N} ldw={ldw}: max|d|={e:.3e} "
                    f"(tol {PARTIAL_TOL[0]:g} + {PARTIAL_TOL[1]:g}|x|)")
    return errs


# the parallel forms' parity (phase_parity_tp): two gloo ranks on cuda:0,
# each form over the pair's one axis line; small shapes
RING_CASES = {"P256_valid250": (256, 250, {}),
              "P256_window64_softcap": (256, 200, {"window": 64, "logit_softcap": 30.0})}
RING_TOL = 1e-4  # f32 on the card against f32 on the CPU
A2A_SHAPE = (64, 128, 128, 8)  # T, D, F, E (kernel g takes D and F on its 64-wide grid)
PP_TOL = 2e-3  # the reference tests' bar for the pipelined forward (f32)
PP_CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=4, num_heads=4,
              num_kv_heads=2, head_dim=32, rope_theta=10000.0, max_position_embeddings=128)


def parallel_parity_inputs(torch, np):
    """Host inputs of the three forms, from numpy seeds: ring q / k / v
    (f32), the all-to-all's tokens and experts (bf16), a tiny f32 llama for
    the pipeline, its prompt and one decode step of four lanes."""
    from dynamo_tpu_torch.engine.torch_engine.weights import init_params
    from dynamo_tpu_torch.models import llama

    rng = np.random.default_rng(31)
    ring = {name: tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                        for s in ((P, 8, 64), (P, 2, 64), (P, 2, 64)))
            for name, (P, _, _) in RING_CASES.items()}
    T, Dm, Fm, E = A2A_SHAPE
    moe_in = tuple(torch.from_numpy((rng.standard_normal(s) / np.sqrt(s[-2] if len(s) > 2 else 1))
                                    .astype(np.float32)).bfloat16()
                   for s in ((T, Dm), (Dm, E), (E, Dm, Fm), (E, Dm, Fm), (E, Fm, Dm)))
    cfg = llama.LlamaConfig(**PP_CFG)
    params = init_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    return ring, moe_in, cfg, params


def parallel_parity_rank(group, ring, moe_in, cfg, params):
    """One of two gloo ranks on cuda:0: the ring over the pair (sp), both
    expert-parallel forms over it (ep; kernel g on each rank's 4 experts),
    and prefill_pp / decode_pp over it (pp), every input moved to the card
    here."""
    import types

    import torch

    from dynamo_tpu_torch.ops import moe
    from dynamo_tpu_torch.parallel import pipeline
    from dynamo_tpu_torch.parallel.ring_attention import ring_prefill_attention

    dev, line = group.device, group.tp
    out = {}
    sp = types.SimpleNamespace(axis=lambda name: line)
    for name, (P, valid, kw) in RING_CASES.items():
        q, k, v = (t.to(dev) for t in ring[name])
        out[f"ring/{name}"] = ring_prefill_attention(sp, q, k, v, valid, **kw)
    ep = types.SimpleNamespace(ep=line, tp=group.dp)  # dp: a one-rank axis
    x, rw, wg, wu, wd = (t.to(dev) for t in moe_in)
    e = wg.shape[0] // 2
    mine = [w[line.rank * e:(line.rank + 1) * e].contiguous() for w in (wg, wu, wd)]
    before = moe.grouped_swiglu_ffn_cuda.launches
    out["ep/a2a"] = moe.moe_ffn_ep_a2a(ep, x, rw, *mine, 2)
    out["ep/psum"] = moe.moe_ffn_shard_map(ep, x, rw, *mine, 2)
    out["ep/kernel_g_launches"] = moe.grouped_swiglu_ffn_cuda.launches - before
    if dev.type == "cpu":  # the plain version runs there (a rehearsal)
        out["ep/kernel_g_launches"] = 2
    pp = types.SimpleNamespace(pp=line)
    stacked = pipeline.shard_stacked_pp(pp, pipeline.stack_layer_params(
        {k: ([{n: t.to(dev) for n, t in lyr.items()} for lyr in v] if k == "layers" else v.to(dev))
         for k, v in params.items()}))
    shape = (cfg.num_layers // 2, cfg.num_kv_heads, 16, 16, cfg.head_dim)
    kc, vc = torch.zeros(shape, device=dev), torch.zeros(shape, device=dev)
    prompt = torch.arange(3, 3 + 64, device=dev) % cfg.vocab_size
    out["pp/prefill"] = pipeline.prefill_pp(stacked, cfg, pp, prompt, 60, kc, vc,
                                            torch.arange(1, 5, device=dev))
    toks, pos, tables, slots = pp_step(torch, dev)
    out["pp/decode"] = pipeline.decode_pp(stacked, cfg, pp, toks, pos, kc, vc, tables, slots)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out


def pp_step(torch, dev):
    """Four lanes after the 60-token prompt (blocks 1-4): tokens, positions,
    block tables and the slots of block 5."""
    toks = torch.tensor([5, 9, 11, 3], device=dev)
    pos = torch.full((4,), 60, device=dev)
    tables = torch.tensor([[1, 2, 3, 4, 5]] * 4, device=dev)
    slots = torch.tensor([5 * 16 + i for i in range(4)], device=dev)
    return toks, pos, tables, slots


def parallel_parity(torch, np, device: str = "cuda") -> dict:
    """Ring attention, the two expert-parallel forms and the pipelined
    forward on two gloo ranks of cuda:0, against one-device versions: the
    ring against the plain causal attention on the CPU (f32, RING_TOL), the
    all-to-all and psum forms against the one-card dropless layer (bf16,
    kernel g on both sides, GEMV_TOL), prefill_pp / decode_pp against the
    serial forward on the CPU (f32, PP_TOL). Returns each check's max |d|."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops import moe
    from dynamo_tpu_torch.parallel.launch import run_ranks

    ring, moe_in, cfg, params = parallel_parity_inputs(torch, np)
    t0 = time.perf_counter()
    ranks = run_ranks(2, parallel_parity_rank, [(ring, moe_in, cfg, params)] * 2,
                      backend="gloo", devices=[f"{device}:0" if device == "cuda" else device] * 2,
                      timeout_s=300)
    errs = {}
    for name, (P, valid, kw) in RING_CASES.items():
        want = A.causal_prefill_attention_plain(*ring[name], valid, **kw)
        for r in ranks:
            errs[f"ring/{name}"] = max(errs.get(f"ring/{name}", 0.0), compare(
                torch, f"ring/{name}", torch.from_numpy(r[f"ring/{name}"])[:valid],
                want[:valid], (RING_TOL, RING_TOL)))
    x, rw, wg, wu, wd = (t.to(device) for t in moe_in)
    want = moe.moe_ffn_dropless(x, rw, wg, wu, wd, 2).float().cpu()
    for r in ranks:
        if r["ep/kernel_g_launches"] != 2:
            raise SmokeError(f"parity_tp/ep: kernel g launched {r['ep/kernel_g_launches']} "
                             "times on a rank, want once per form")
        for form in ("ep/a2a", "ep/psum"):
            errs[form] = max(errs.get(form, 0.0), compare(
                torch, f"parity_tp/{form}", torch.from_numpy(r[form]), want, GEMV_TOL))
    shape = (cfg.num_layers, cfg.num_kv_heads, 16, 16, cfg.head_dim)
    kc, vc = torch.zeros(shape), torch.zeros(shape)
    prompt = torch.arange(3, 3 + 64) % cfg.vocab_size
    want_p = llama.prefill(params, cfg, prompt, 60, kc, vc, torch.arange(1, 5))
    toks, pos, tables, slots = pp_step(torch, "cpu")
    want_d = llama.decode(params, cfg, toks, pos, kc, vc, tables, slots)
    for r in ranks:
        errs["pp/prefill"] = max(errs.get("pp/prefill", 0.0), compare(
            torch, "parity_tp/pp/prefill", torch.from_numpy(r["pp/prefill"]), want_p,
            (PP_TOL, PP_TOL)))
        errs["pp/decode"] = max(errs.get("pp/decode", 0.0), compare(
            torch, "parity_tp/pp/decode", torch.from_numpy(r["pp/decode"]), want_d,
            (PP_TOL, PP_TOL)))
    log(f"parity_tp/parallel: ring (sp 2), a2a + psum (ep 2, kernel g per rank) and "
        f"prefill_pp / decode_pp (pp 2) on two gloo ranks of cuda:0 against one device: "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} } in {time.perf_counter() - t0:.1f} s")
    return errs


def partial_bound(M: int, K: int, N: int, w_bytes: int) -> tuple[float, str, float, float]:
    """Least time for 5p / 5pq: the [K, N] weight (bf16 or int8) and the
    [M, K] bf16 input read once, the [M, N] f32 output written once; 2 M K N
    tensor-core operations (the int8 mantissas are widened to bf16)."""
    nbytes = K * N * w_bytes + M * K * 2 + M * N * 4
    flops = 2 * M * K * N
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations", nbytes, flops


def tp_partial_times(torch, card: str) -> dict:
    """5p and 5pq at M = 8 (the B=8 fused step) and 32 at each per-rank
    shape: kernel, plain, and the library yardstick: one cuBLAS bf16
    product with f32 output (torch.mm(..., out_dtype=torch.float32)) over
    the same shard, for 5pq over the mantissas widened to bf16
    beforehand."""
    from dynamo_tpu_torch.ops import cuda_linear as KL
    from dynamo_tpu_torch.ops import linear as L

    flush = make_flush(torch)
    rows = {}
    for shape, (K, N, ldw, col) in PARTIAL_SHAPES.items():
        for M in (8, 32):
            attn, w, q8 = partial_inputs(torch, M, K, N, ldw, col, seed=95 + M)
            wide = q8.to(torch.bfloat16)
            for name, fn, ww, lib_w, wb in (
                    (TP_KERNELS[0], KL.fused_attn_out_partial_cuda, w, w, 2),
                    (TP_KERNELS[1], KL.fused_attn_out_partial_int8_cuda, q8, wide, 1)):
                t_k = time_ms(torch, lambda: fn(attn, ww), flush=flush)
                t_p = time_ms(torch, lambda: L.fused_attn_out_partial_plain(attn, ww), flush=flush)
                t_l = time_ms(torch, lambda: torch.mm(attn, lib_w, out_dtype=torch.float32),
                              flush=flush)
                b_ms, b_by, nbytes, flops = partial_bound(M, K, N, wb)
                rows[f"{name}/{shape}/M{M}"] = {
                    "ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
                    "bound_by": b_by, "bytes": nbytes, "flops": flops,
                    "ratio_to_library": t_k["median"] / t_l["median"],
                    "library": "torch.mm(attn, w, out_dtype=torch.float32) over the same shard"
                               + (" (mantissas widened to bf16 beforehand)" if wb == 1 else ""),
                    "shape": f"M={M} K={K} N={N} ldw={ldw} {'int8' if wb == 1 else 'bf16'} w",
                }
    # #2 on one rank's heads of Llama-3.1-8B tp=2 (Hq 16, Hkv 4): what each
    # rank of serve_tp's spec leg verifies with
    rows["paged_verify_attention/llama31_8b_tp2"] = verify_row(torch, flush, hq=HQ // TP,
                                                               hkv=HKV // TP)
    for name, row in rows.items():
        print(json.dumps({"kernel_time": name, "card": card, **row}), flush=True)
        log(f"{name} {row['shape']}: {row['ms']['median']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}), plain {row['plain_ms']['median']:.4f} ms, library "
            f"{row['library_ms']['median']:.4f} ms ({card})")
    return rows


def step_inputs(np, runner, prompts):
    """A packed prefill of ``prompts`` (blocks from 1 on; at most the
    runner's 512-token buffer) and the decode step after it:
    (pack_prefill's arrays, decode arrays)."""
    from dynamo_tpu_torch.ops.sampling import MAX_EOS_IDS

    bs = runner.block_size
    specs, tables, nxt = [], [], 1
    for p in prompts:
        n = -(-(len(p) + 1) // bs)
        blocks = list(range(nxt, nxt + n))
        nxt += n
        specs.append((p, blocks, 0.0, 1.0, 0, 1.0, np.zeros(2, np.int64),
                      np.full(MAX_EOS_IDS, -1, np.int64), False))
        tables.append(blocks)
    B = len(prompts)
    table = np.zeros((B, runner.max_blocks_per_seq), np.int32)
    for i, b in enumerate(tables):
        table[i, :len(b)] = b
    pos = np.array([len(p) for p in prompts], np.int64)
    slots = table[np.arange(B), pos // bs].astype(np.int64) * bs + pos % bs
    return runner.pack_prefill(specs), (np.arange(B, dtype=np.int64) + 7, pos, table, slots)


def first_step_logits(torch, np, runner, prompts):
    """The logits of the decode step right after a packed prefill of
    ``prompts`` (every rank runs both through the engine's runner)."""
    packed, (toks, pos, table, slots) = step_inputs(np, runner, prompts)
    runner.fetch_sample(runner.prefill_packed_arrays(**packed))
    with torch.inference_mode():
        return runner.decode_logits(toks, pos, table, slots).float().cpu()


TP_STEP_PROMPTS = 8  # the B=8 step: 8 prompts of 64 tokens


def tp_step_times(torch, np, runner, reps: int = 5) -> dict:
    """Wall time of the B=8 fused decode step through the engine's runner
    (host clock around decode + fetch; on a tensor-parallel runner every
    rank runs it) and, with a group, the leader's host time inside its
    collectives and the bytes it staged through host memory per step."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, LLAMA31_8B["vocab_size"], 64).tolist() for _ in range(TP_STEP_PROMPTS)]
    packed, (toks, pos, table, slots) = step_inputs(np, runner, prompts)
    B = len(prompts)
    args = (np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int64))
    runner.fetch_sample(runner.prefill_packed_arrays(**packed))
    runner.fetch_sample(runner.decode(toks, pos, table, slots, *args))  # warm
    group = getattr(runner, "group", None)
    times, coll, staged = [], [], []
    for _ in range(reps):
        c0 = group.seconds if group else 0.0
        b0 = group.staged_bytes if group else 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.fetch_sample(runner.decode(toks, pos, table, slots, *args))
        times.append((time.perf_counter() - t0) * 1e3)
        if group:
            coll.append((group.seconds - c0) * 1e3)
            staged.append(group.staged_bytes - b0)
    out = {"step_ms": statistics.median(times), "step_ms_all": times, "B": B, "ctx": 64}
    if group:
        out.update(collective_ms=statistics.median(coll), staged_bytes=staged[0],
                   collective_share=statistics.median(coll) / statistics.median(times))
    return out


def serve_tp_leg(torch, np, card: str, quant: bool, reqs, Context, FinishReason,
                 after=None) -> dict:
    """One leg of serve_tp: the one-card engine (reference logits and
    tokens), then the tp=2 engine on the same seeded weights, two ranks on
    cuda:0 over gloo; checks and reads each rank's counters. ``after(one,
    engine)``, when given, runs next with both engines still open (its
    result under the key "after"); then both close."""
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.ops import kernels

    kw = dict(max_batch=8, max_model_len=MAX_MODEL_LEN, seed=0, fused_decode=True,
              spec_k=0, quantize=quant, kv_dtype="int8" if quant else "bf16",
              num_blocks=TP_BLOCKS, **EAGER)
    tag = "int8" if quant else "bf16"
    rng = np.random.default_rng(3)
    probe = [rng.integers(0, LLAMA31_8B["vocab_size"], n).tolist() for n in (16, 100, 300)]

    one = build_torch_engine(TP_MODEL, device="cuda", **kw)
    want = first_step_logits(torch, np, one.runner, probe)
    one_steps = tp_step_times(torch, np, one.runner)

    one_out = asyncio.run(run_requests(one, reqs, Context))
    if after is None:
        asyncio.run(one.close())
        del one
        gc.collect()
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    engine = build_torch_engine(TP_MODEL, device="cuda", tensor_parallel_size=TP,
                                tp_backend="gloo", tp_devices=["cuda:0"] * TP, **kw)
    build_s = time.perf_counter() - t0
    runner = engine.runner
    got = first_step_logits(torch, np, runner, probe)
    err = (got - want).abs()
    scale = want.abs().amax(dim=-1, keepdim=True)
    worst = float((err / scale).max())
    if not torch.isfinite(got).all() or worst > TP_LOGIT_TOL:
        raise SmokeError(f"serve_tp/{tag}: first-step logits {worst:.4f} of the row's max "
                         f"apart from the one-card engine's (tol {TP_LOGIT_TOL})")
    argmax_same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    steps = tp_step_times(torch, np, runner)
    # every rank's counters to 0 just before the path, read just after
    runner.rank_stats(reset=True)
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    out = asyncio.run(run_requests(engine, reqs, Context))
    wall = time.perf_counter() - t1
    stats = stats_dict(engine.stats)
    ranks = runner.rank_stats()
    done = after(one, engine) if after is not None else None
    if after is not None:
        asyncio.run(one.close())
    asyncio.run(engine.close())
    if [p.exitcode for p in runner._processes] != [0] * (TP - 1):
        raise SmokeError(f"serve_tp/{tag}: followers ended {[p.exitcode for p in runner._processes]}")
    for i, ((toks, reason, _), req) in enumerate(zip(out, reqs)):
        if reason is not FinishReason.LENGTH or len(toks) != req.stop.max_tokens:
            raise SmokeError(f"serve_tp/{tag} request {i}: {len(toks)} tokens, reason {reason}")
    L = TP_MODEL["num_hidden_layers"]
    fused_steps = stats["decode_steps"] + stats["mixed_steps"]
    sfx = "_int8" if quant else ""
    per_rank = L * fused_steps
    for r, st in enumerate(ranks):
        lc = st["launches"]
        for k in (f"paged_decode_attention{sfx}", f"fused_qkv_rope{sfx}",
                  f"fused_attn_out_partial{sfx}"):
            if lc[k] != per_rank:
                raise SmokeError(f"serve_tp/{tag} rank {r}: {k} launched {lc[k]} times, "
                                 f"expected {L} x {fused_steps} fused steps")
        moved = {k for k, v in lc.items() if v}
        if moved != {f"paged_decode_attention{sfx}", f"fused_qkv_rope{sfx}",
                     f"fused_attn_out_partial{sfx}"}:
            raise SmokeError(f"serve_tp/{tag} rank {r}: unexpected kernels moved: {lc}")
    launches = {k: sum(st["launches"][k] for st in ranks) for k in kernels.KERNELS}
    if launches[f"fused_attn_out_partial{sfx}"] != L * fused_steps * TP:
        raise SmokeError(f"serve_tp/{tag}: 5p launches {launches} != {L} x {fused_steps} x {TP}")
    n_tok = sum(len(t) for t, _, _ in one_out)
    agree = sum(a == b for (x, _, _), (y, _, _) in zip(one_out, out) for a, b in zip(x, y)) / n_tok
    # random weights leave near-tied logits: after one flipped token a
    # request's continuation differs, so the first divergence is reported too
    diverge = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b), len(x))
               for (x, _, _), (y, _, _) in zip(one_out, out)]
    res = {
        "weights": tag, "build_s": build_s, "requests": len(reqs), "stats": stats,
        "wall_s": wall, "output_tok_per_s": sum(len(t) for t, _, _ in out) / wall,
        "first_step_max_rel_err": worst, "first_step_argmax_same": argmax_same,
        "greedy_token_agreement": agree, "first_divergence": diverge,
        "rank_launches": [st["launches"] for st in ranks],
        "rank_peak_mem_bytes": [st.get("peak_mem_bytes") for st in ranks],
        "rank_staged_bytes": [st["staged_bytes"] for st in ranks],
        "rank_collective_s": [st["collective_s"] for st in ranks],
        "step_tp2": steps, "step_one_card": one_steps, "launches_summed": launches,
    }
    log(f"serve_tp/{tag}: {len(reqs)} requests in {wall:.2f} s, {stats['mixed_steps']} mixed + "
        f"{stats['decode_steps']} decode steps, {stats['packed_prefills']} packed prefills; "
        f"first-step logits within {worst:.4f} of the row max (argmax same {argmax_same:.3f}); "
        f"greedy tokens agreeing with one card {agree:.3f} (first divergence per request "
        f"{diverge}); 5p launches {launches[f'fused_attn_out_partial{sfx}']}"
        f" (= {L} x {fused_steps} x {TP}); B=8 step {steps['step_ms']:.1f} ms (one card "
        f"{one_steps['step_ms']:.1f} ms), collectives {steps['collective_ms']:.1f} ms of it; "
        f"peak memory per rank {[round(m / 1e9, 2) for m in res['rank_peak_mem_bytes']]} GB ({card})")
    print(json.dumps({"serve_tp": res, "card": card}), flush=True)
    res["after"] = done
    return res


class TPLandingCheck:
    """Holds every landing of a disaggregated leg across tensor-parallel
    sizes to the blocks the prefill side wrote: each host extract of the
    prefill runner (a group's gathers every rank's heads) is kept, each
    inject of the decode runner must carry one of them (and takes it); the
    blocks the decode side then holds, read back (a group gathers rank r's
    heads into [r Hkv / tp, (r + 1) Hkv / tp)), must equal them bitwise,
    and the decode leader's own cache must hold exactly its head slice."""

    def __init__(self, torch, np, prefill, decode) -> None:
        import collections

        self.sent: collections.deque = collections.deque()
        self.landings: list = []
        pr, dr = prefill.runner, decode.runner
        real_extract, real_inject = pr.extract_blocks, dr.inject_blocks

        def extract(ids):
            got = real_extract(ids)
            self.sent.append([np.array(a) for a in got])
            return got

        def inject(ids, k, v):
            real_inject(ids, k, v)
            n = len(ids)
            # the extract these blocks came from (streams may interleave)
            at = next((i for i, w in enumerate(self.sent) if w[0].shape[2] >= n
                       and np.array_equal(np.asarray(k), w[0][:, :, :n])), None)
            if at is None:
                self.landings.append({"blocks": n, "heads_per_rank": 0, "ok": False})
                return
            sent = self.sent[at]
            del self.sent[at]
            want = [w[:, :, :n] for w in sent]
            back = dr.extract_blocks(ids)
            kc = dr.k_cache
            h = kc.shape[1]
            lead = kc[:, :, list(ids)].contiguous().view(torch.int16).cpu().numpy().view(np.uint16)
            ok = (all(np.array_equal(np.asarray(x), w) for x, w in zip((k, v), want))
                  and all(np.array_equal(b, w) for b, w in zip(back, want))
                  and np.array_equal(lead, want[0][:, :h]))
            self.landings.append({"blocks": n, "heads_per_rank": h, "ok": bool(ok)})

        pr.extract_blocks = extract
        dr.inject_blocks = inject

    def take(self, tag: str) -> dict:
        rows, self.landings = self.landings, []
        if not rows or not all(r["ok"] for r in rows) or self.sent:
            raise SmokeError(f"{tag}: landings {rows}, {len(self.sent)} extracts never landed")
        return {"landings": len(rows), "blocks": sum(r["blocks"] for r in rows),
                "heads_per_rank": rows[0]["heads_per_rank"]}


def serve_tp_disagg(torch, np, card: str, every, Context, FinishReason) -> dict:
    """Disaggregation and the tiers under a tensor-parallel group (the
    docstring's phase 11, its last legs): a tp = 1 engine and a tp = 2 group
    (two gloo ranks on cuda:0, host tiers of DYN_KV_HOST_OFFLOAD_GB) at 8B
    width on the same seeded weights; the tp = 1 engine ships serve's two
    longest prompts to the group, streamed and monolithic, the group ships
    the longest to the tp = 1 engine, then the group onboards a 1024-token
    prefix from its tier. Every landing bitwise per rank, every stream held
    to the dense reference. gloo time-slices one card: the times are
    printed and compared with nothing."""
    from dynamo_tpu_torch.disagg.colocated import HostPrefillClient
    from dynamo_tpu_torch.disagg.router import DisaggConfig, DisaggregatedRouter
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest, SamplingOptions, StopConditions

    def greedy(prompt, n=16):
        return PreprocessedRequest(token_ids=list(prompt), sampling=SamplingOptions(greedy=True),
                                   stop=StopConditions(max_tokens=n, ignore_eos=True))

    kw = dict(max_batch=8, max_model_len=MAX_MODEL_LEN, seed=0, num_blocks=TP_BLOCKS, **EAGER)
    t0 = time.perf_counter()
    one = build_torch_engine(TP_MODEL, device="cuda", **kw)
    os.environ["DYN_KV_HOST_OFFLOAD_GB"] = TP_TIER_GB
    try:
        grp = build_torch_engine(TP_MODEL, device="cuda", tensor_parallel_size=TP, tp_backend="gloo",
                                 tp_devices=["cuda:0"] * TP, **kw)
    finally:
        del os.environ["DYN_KV_HOST_OFFLOAD_GB"]
    build_s = time.perf_counter() - t0
    longest = sorted(every, key=lambda r: len(r.token_ids))[-2:]
    res: dict = {"card": card, "build_s": build_s, "legs": {}}
    gaps = []

    async def leg(tag, prefill, decode, prompts, stream):
        # the group's tier would hold the prompts of an earlier leg, and a
        # prompt found there is not shipped
        await grp.drain_offloads()
        await grp.clear_kv_blocks()
        shipped0, fell0 = decode.stats.remote_prefills, decode.stats.remote_fallbacks
        probe = TPLandingCheck(torch, np, prefill, decode)
        decode.disagg_router = DisaggregatedRouter(DisaggConfig())
        decode.remote_prefill_client = HostPrefillClient(prefill, BLOCK)
        os.environ["DYN_KV_STREAM"] = "1" if stream else "0"
        try:
            t = time.perf_counter()
            out = [(await run_requests(decode, [greedy(r.token_ids)], Context))[0] for r in prompts]
            wall = time.perf_counter() - t
        finally:
            del os.environ["DYN_KV_STREAM"]
            decode.disagg_router = decode.remote_prefill_client = None
            for runner in (prefill.runner, decode.runner):
                for name in ("extract_blocks", "inject_blocks"):
                    runner.__dict__.pop(name, None)
        for (toks, reason, _), r in zip(out, prompts):
            if reason is not FinishReason.LENGTH or len(toks) != 16:
                raise SmokeError(f"serve_tp/{tag}: {len(toks)} tokens, {reason}")
            gaps.append(reference_check(torch, one.runner, list(r.token_ids), toks))
        row = {**probe.take(f"serve_tp/{tag}"), "wall_s": wall,
               "remote_prefills": decode.stats.remote_prefills - shipped0,
               "remote_fallbacks": decode.stats.remote_fallbacks - fell0}
        if row["remote_fallbacks"] or row["remote_prefills"] != len(prompts):
            raise SmokeError(f"serve_tp/{tag}: {row['remote_prefills']} remote prefills, "
                             f"{row['remote_fallbacks']} fallbacks for {len(prompts)} prompts")
        res["legs"][tag] = row
        log(f"serve_tp/{tag}: {len(prompts)} prompt(s) of {[len(r.token_ids) for r in prompts]} tokens "
            f"shipped, {row['landings']} landings of {row['blocks']} blocks, each rank's "
            f"{row['heads_per_rank']} heads bitwise; {wall:.2f} s with 16 tokens out ({card})")

    async def tiers():
        """The group onboards a 1024-token prefix its first request
        offloaded: the tier's pages land on every rank bitwise."""
        bm, runner = grp.block_manager, grp.runner
        stored, checked = {}, []
        real_store, real_load, real_inject = bm.store_blocks_device, bm.load_blocks_device, runner.inject_pages
        loaded = []

        def store(hashes, *pages):
            for i, h in enumerate(hashes):
                stored[h] = [p[i].clone() for p in pages]
            return real_store(hashes, *pages)

        def load(hashes, device):
            pages = real_load(hashes, device)
            loaded.append(list(hashes))
            return pages

        def inject(ids, *pages):
            real_inject(ids, *pages)
            hashes = loaded.pop(0)
            back = runner.extract_pages(ids)
            ok = all(torch.equal(p[j].cpu(), stored[h][c].cpu()) and torch.equal(b[j].cpu(), p[j].cpu())
                     for j, h in enumerate(hashes) for c, (p, b) in enumerate(zip(pages, back)))
            checked.append((len(ids), ok))

        bm.store_blocks_device, bm.load_blocks_device, runner.inject_pages = store, load, inject
        await grp.drain_offloads()
        await grp.clear_kv_blocks()
        rng = np.random.default_rng(11)
        pfx = rng.integers(0, LLAMA31_8B["vocab_size"], 1024).tolist()
        prompts = [pfx + rng.integers(0, LLAMA31_8B["vocab_size"], 64).tolist() for _ in range(2)]
        try:
            walls = []
            for p in prompts:
                t = time.perf_counter()
                (toks, reason, _), = await run_requests(grp, [greedy(p)], Context)
                walls.append(time.perf_counter() - t)
                await grp.drain_offloads()
                gaps.append(reference_check(torch, one.runner, p, toks))
        finally:
            for name in ("store_blocks_device", "load_blocks_device"):
                bm.__dict__.pop(name, None)
            runner.__dict__.pop("inject_pages", None)
        s = grp.stats
        if not checked or not all(ok for _, ok in checked) or sum(n for n, _ in checked) != 64 or (
                s.kv_offload_errors or s.kv_onboard_errors):
            raise SmokeError(f"serve_tp/tiers: onboards {checked}, stats onboarded "
                             f"{s.kv_onboarded_blocks}, errors {s.kv_offload_errors} / {s.kv_onboard_errors}")
        res["tiers"] = {"onboarded_blocks": s.kv_onboarded_blocks, "offloaded_blocks": s.kv_offloaded_blocks,
                        "wall_s": walls, "pages_checked": sum(n for n, _ in checked)}
        log(f"serve_tp/tiers: the tp=2 group (DYN_KV_HOST_OFFLOAD_GB={TP_TIER_GB}) offloaded "
            f"{s.kv_offloaded_blocks} blocks in all, onboarded {res['tiers']['pages_checked']} of the "
            f"1024-token prefix for the second request, every page bitwise on both ranks; walls miss / hit "
            f"{walls[0]:.2f} / {walls[1]:.2f} s ({card})")

    async def go():
        try:
            for stream in (True, False):
                await leg(f"tp1_to_tp2_{'streamed' if stream else 'monolithic'}", one, grp, longest, stream)
            await leg("tp2_to_tp1_streamed", grp, one, longest[-1:], True)
            await tiers()
        finally:
            await grp.close()
            await one.close()

    asyncio.run(go())
    res["reference_max_logit_gap"] = max(gaps)
    if [p.exitcode for p in grp.runner._processes] != [0] * (TP - 1):
        raise SmokeError(f"serve_tp/disagg: followers ended {[p.exitcode for p in grp.runner._processes]}")
    log(f"serve_tp/disagg: every stream within {max(gaps):.4f} of the dense reference's best logit; "
        f"build {build_s:.1f} s ({card})")
    print(json.dumps({"serve_tp_disagg": res}), flush=True)
    return res


TP_SPEC_LANES = 8  # serve_tp's spec leg: greedy prompts of 200-1200 tokens
CP = 2  # the CP leg's sp ranks: two node processes on cuda:0 over gloo
CP_PROMPT = 4000  # its prompt: bucket 4096, past cp_min_tokens (512), so the ring runs
CP_OUT = 8
CP_LEASE_TTL_S = 10.0  # each node's bring-up lease; keepalives every third of it
CP_KW = dict(max_batch=8, max_model_len=MAX_MODEL_LEN, seed=0, num_blocks=TP_BLOCKS,
             prefill_chunk_tokens=0, **EAGER)  # every node builds its rank with these


def greedy_request(prompt, n: int):
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest, SamplingOptions, StopConditions

    return PreprocessedRequest(token_ids=list(prompt), sampling=SamplingOptions(greedy=True),
                               stop=StopConditions(max_tokens=n, ignore_eos=True))


def rel_logit_err(torch, got, want) -> float:
    """The largest |got - want| of a row over that row's largest |want|
    (serve_tp's measure against one card), or inf when got is not finite."""
    if not torch.isfinite(got).all():
        return float("inf")
    return float(((got - want).abs() / want.abs().amax(dim=-1, keepdim=True)).max())


def verify_logits_after(torch, np, runner, prompts, fed):
    """Each prompt prefilled into its own blocks (from block 1 on), then
    one verify pass of the [B, S] ``fed`` tokens right after the prompts:
    its logits [B, S, V] on the host."""
    bs, S = runner.block_size, fed.shape[1]
    B = len(prompts)
    tables = np.zeros((B, runner.max_blocks_per_seq), np.int32)
    nxt = 1
    for i, p in enumerate(prompts):
        n = -(-(len(p) + S) // bs)
        blocks = list(range(nxt, nxt + n))
        nxt += n
        tables[i, :n] = blocks
        runner.fetch_sample(runner.prefill(list(p), blocks, 0.0, 1.0, 0))
    positions = np.array([len(p) for p in prompts])[:, None] + np.arange(S)[None, :]
    slots = tables[np.arange(B)[:, None], positions // bs].astype(np.int64) * bs + positions % bs
    with torch.inference_mode():
        return runner.verify_logits(fed, positions, tables, slots).float().cpu()


def rank_launch_check(tag: str, ranks: list, want: dict) -> None:
    """Every rank launched exactly ``want`` (kernel -> count) and nothing
    else."""
    for r, st in enumerate(ranks):
        moved = {k: v for k, v in st["launches"].items() if v}
        if moved != {k: v for k, v in want.items() if v}:
            raise SmokeError(f"{tag} rank {r}: launches {moved} != {want}")


class ContinuationDrafter:
    """Drafts each lane's known continuation: the tokens the same group
    served for the same prompt with spec off, from the lane's own position
    on (a prompt-lookup drafter whose table is that continuation). While a
    lane agrees with it the verify pass accepts the drafts; past a near-tie
    that flipped, its drafts are rejected, and every dispatch still
    verifies."""

    def __init__(self, k: int, conts: list) -> None:
        self.max_k = k
        self.conts = conts  # [(prompt, continuation)]

    def draft(self, token_ids: list, k: Optional[int] = None) -> list:
        k = self.max_k if k is None else min(k, self.max_k)
        for prompt, cont in self.conts:
            if len(token_ids) >= len(prompt) and token_ids[:len(prompt)] == prompt:
                n = len(token_ids) - len(prompt)
                return list(cont[n:n + k])
        return []


def serve_tp_spec(torch, np, card: str, one, engine, Context, FinishReason) -> dict:
    """Spec decode under tensor parallelism, on the bf16 leg's engines (its
    ``after``): the verify pass's logits of the tp = 2 group (two gloo
    ranks on cuda:0, fused heads on) against the one-card runner's on the
    same prompts and fed tokens, within TP_LOGIT_TOL of each row's max;
    then TP_SPEC_LANES greedy prompts served by the group with spec off and
    with spec_k 3, both at the decode horizon HORIZON (every verify chains
    HORIZON - 1 decode steps over OP_VERIFY). The spec engine drafts each
    lane's spec-off continuation (``ContinuationDrafter``), so accepted
    drafts, chained steps and the accepted tokens' K/V all run; every
    rank's counters are set to 0 just before it serves and read just after
    (#2 once a layer per verify dispatch, #1 once a layer per step body,
    #4 and 5p once a layer per body or verify dispatch). Each lane's spec-on
    tokens equal its spec-off ones up to their first difference, which must
    be a near-tie of the dense reference (one card's weights), and the
    first 32 of each stream pass ``reference_check``. Closing the engines
    stops the followers."""
    from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine

    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    vocab = LLAMA31_8B["vocab_size"]
    prompts = [rng.integers(0, vocab, int(n)).tolist()
               for n in rng.integers(200, 1200, TP_SPEC_LANES)]
    fed = rng.integers(0, vocab, (len(prompts), SPEC_K + 1))
    runner = engine.runner
    want = verify_logits_after(torch, np, one.runner, prompts, fed)
    got = verify_logits_after(torch, np, runner, prompts, fed)
    worst = rel_logit_err(torch, got, want)
    if worst > TP_LOGIT_TOL:
        raise SmokeError(f"serve_tp/spec: verify logits {worst:.4f} of the row's max apart from "
                         f"one card's (tol {TP_LOGIT_TOL})")
    argmax_same = float((got.argmax(-1) == want.argmax(-1)).float().mean())

    reqs = [greedy_request(p, SPEC_MAX_TOKENS) for p in prompts]
    cfg = dataclasses.replace(engine.config, decode_horizon=HORIZON)

    async def serve():  # both engines in one event loop; closing either stops the followers
        plain = TorchEngine(runner, cfg)
        spec = TorchEngine(runner, dataclasses.replace(cfg, spec_k=SPEC_K,
                                                       spec_min_coverage=SPEC_COVERAGE))
        try:
            off = await run_requests(plain, reqs, Context)
            spec.drafter = ContinuationDrafter(SPEC_K, [(p, t) for p, (t, _, _) in zip(prompts, off)])
            runner.rank_stats(reset=True)
            t1 = time.perf_counter()
            out = await run_requests(spec, reqs, Context)
            wall = time.perf_counter() - t1
            return off, out, wall, stats_dict(spec.stats), runner.rank_stats()
        finally:
            await spec.close()
            await plain.close()

    off, out, wall, stats, ranks = asyncio.run(serve())
    for i, (toks, reason, _) in enumerate(out + off):
        if reason is not FinishReason.LENGTH or len(toks) != SPEC_MAX_TOKENS:
            raise SmokeError(f"serve_tp/spec stream {i}: {len(toks)} tokens, reason {reason}")
    L = TP_MODEL["num_hidden_layers"]
    verify, chained = stats["verify_steps"], stats["verify_chained_steps"]
    accepted = stats["num_accepted_tokens"]
    if verify < 4 or accepted < 1 or chained != (HORIZON - 1) * verify:
        raise SmokeError(f"serve_tp/spec: {verify} verify dispatches (want >= 4), {accepted} "
                         f"accepted drafts (want > 0), {chained} chained steps (want "
                         f"{HORIZON - 1} a dispatch): {stats}")
    bodies = stats["decode_steps"] + stats["mixed_steps"] + stats["horizon_steps"] + chained
    rank_launch_check("serve_tp/spec", ranks, {
        "paged_verify_attention": L * verify, "paged_decode_attention": L * bodies,
        "fused_qkv_rope": L * (verify + bodies), "fused_attn_out_partial": L * (verify + bodies),
        "flash_prefill_attention": L * stats["prefills"]})
    # spec on against spec off, both on the group: equal up to the first
    # difference, a near-tie of the dense reference there
    prefix, gaps = [], []
    for p, (a, _, _), (b, _, _) in zip(prompts, out, off):
        j = next((n for n, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
        prefix.append(j)
        gaps.append(reference_check(torch, one.runner, p, a, n_check=32))
        if j < len(a):
            row = dense_logits(torch, one.runner, p + a[:j])[len(p) + j - 1].float()
            tie = float(row.max()) - min(float(row[a[j]]), float(row[b[j]]))
            gaps.append(tie)
            if tie > 0.25:
                raise SmokeError(f"serve_tp/spec: spec on and off part at token {j} by {tie:.3f} "
                                 f"below the dense reference's best logit: not a near-tie")
    res = {
        "requests": len(reqs), "prompt_lens": [len(p) for p in prompts], "stats": stats,
        "verify_logits_max_rel_err": worst, "verify_argmax_same": argmax_same, "wall_s": wall,
        "acceptance": accepted / max(1, stats["num_draft_tokens"]),
        "common_prefix_spec_on_off": prefix, "reference_max_logit_gap": max(gaps),
        "rank_launches": [st["launches"] for st in ranks],
        "rank_staged_bytes": [st["staged_bytes"] for st in ranks],
        "rank_collective_s": [st["collective_s"] for st in ranks],
        "leg_s": time.perf_counter() - t0,
    }
    log(f"serve_tp/spec: tp=2 verify logits within {worst:.4f} of one card's row max (argmax "
        f"same {argmax_same:.3f}); {len(reqs)} greedy requests at H {HORIZON} in {wall:.2f} s: "
        f"{verify} verify dispatches ({chained} chained steps), {stats['horizon_dispatches']} "
        f"horizon dispatches, {stats['decode_steps']} decode steps; drafts "
        f"{stats['num_draft_tokens']} tokens, accepted {accepted} per position "
        f"{stats['accepted_per_pos']} (acceptance {res['acceptance']:.3f}); spec on = off for "
        f"the first {prefix} tokens, reference gap {max(gaps):.3f}; per rank #2 "
        f"{ranks[0]['launches']['paged_verify_attention']}, 5p "
        f"{ranks[0]['launches']['fused_attn_out_partial']}, #1 "
        f"{ranks[0]['launches']['paged_decode_attention']}; collectives "
        f"{[round(st['collective_s'], 2) for st in ranks]} s, staged "
        f"{[st['staged_bytes'] for st in ranks]} B ({card})")
    print(json.dumps({"serve_tp_spec": res, "card": card}), flush=True)
    return res


def cp_reference(torch, np, one, Context) -> dict:
    """One card's side of the CP leg, on the bf16 leg's one-card engine:
    #3's prefill logits of the CP prompt (its launches counted), the decode
    step's after it, and the prompt served greedily."""
    from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine
    from dynamo_tpu_torch.ops import kernels

    prompt = np.random.default_rng(21).integers(0, LLAMA31_8B["vocab_size"], CP_PROMPT).tolist()
    blocks = list(range(1, 2 + CP_PROMPT // BLOCK))
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    want_p = one.runner.prefill_logits(prompt, blocks).float().cpu()
    ref = {"prompt": prompt, "prefill_s": time.perf_counter() - t, "prefill": want_p,
           "launches": kernels.launch_counts()}
    with torch.inference_mode():
        ref["decode"] = one.runner.decode_logits(*cp_step(np, len(blocks))).float().cpu()

    async def serve():  # an engine serves in one event loop: a fresh one over one's runner
        eng = TorchEngine(one.runner, one.config)
        try:
            return await run_requests(eng, [greedy_request(prompt, CP_OUT)], Context)
        finally:
            await eng.close()

    (ref["tokens"], _, _), = asyncio.run(serve())
    return ref


def cp_step(np, runner_blocks: int):
    """The decode step right after the CP prompt: token 7 at position
    CP_PROMPT in the prompt's blocks (1..)."""
    table = np.zeros((1, MAX_BLOCKS), np.int32)
    table[0, :runner_blocks] = np.arange(1, runner_blocks + 1)
    pos = np.array([CP_PROMPT], np.int64)
    slots = table[0, CP_PROMPT // BLOCK].astype(np.int64)[None] * BLOCK + pos % BLOCK
    return np.array([7], np.int64), pos, table, slots


async def cp_grid_leader(torch, np, fport: int, prompt, Context):
    """Node 0 of the CP leg: its fabric lease (kept alive while its engine
    lives: the other node follows it), the grid brought up by
    build_torch_engine(multinode=...) off the event loop, then the prefill
    and decode logits, and one request served; the engine closed last (its
    follower stops)."""
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.fabric.client import FabricClient
    from dynamo_tpu_torch.parallel.multinode import MultiNodeConfig

    fabric = await FabricClient.connect(f"127.0.0.1:{fport}")
    lease = await fabric.lease_grant(CP_LEASE_TTL_S)

    async def keepalive():
        while True:
            await asyncio.sleep(CP_LEASE_TTL_S / 3)
            await fabric.lease_keepalive(lease)

    ka = asyncio.get_running_loop().create_task(keepalive())
    loop = asyncio.get_running_loop()
    t0 = time.perf_counter()
    engine = await loop.run_in_executor(None, lambda: build_torch_engine(
        TP_MODEL, device="cuda", context_parallel_size=CP, tp_backend="gloo",
        multinode=MultiNodeConfig(num_nodes=CP, node_rank=0), fabric=fabric, lease_id=lease,
        **CP_KW))
    out = {"bringup_s": time.perf_counter() - t0}
    try:
        runner = engine.runner
        blocks = list(range(1, 2 + CP_PROMPT // BLOCK))

        def logits():
            runner.rank_stats(reset=True)
            t = time.perf_counter()
            p = runner.prefill_logits(prompt, blocks).float().cpu()
            out["prefill_s"] = time.perf_counter() - t
            with torch.inference_mode():
                d = runner.decode_logits(*cp_step(np, len(blocks))).float().cpu()
            return p, d, runner.rank_stats()

        out["prefill"], out["decode"], out["logit_ranks"] = await loop.run_in_executor(None, logits)
        await loop.run_in_executor(None, lambda: runner.rank_stats(reset=True))
        t = time.perf_counter()
        out["served"] = await run_requests(engine, [greedy_request(prompt, CP_OUT)], Context)
        out["serve_s"] = time.perf_counter() - t
        out["stats"] = stats_dict(engine.stats)
        out["serve_ranks"] = await loop.run_in_executor(None, lambda: runner.rank_stats())
        out["sp"] = runner.group.sp.world_size
    finally:
        await engine.close()
        ka.cancel()
        await fabric.close()
    return out


def serve_tp_cp(torch, np, card: str, ref: dict, Context, FinishReason) -> dict:
    """Context-parallel prefill over sp = 2, against ``ref`` (one card's #3
    prefill logits of a CP_PROMPT-token prompt, the decode step's after it
    and its greedy tokens, ``cp_reference``): a grid of two node processes
    on cuda:0 over gloo brought up through the multi-node rendezvous (a
    fabric server, this process node 0, ``--cp-node`` node 1,
    DYN_NUM_NODES=2): its ring prefill's logits and the decode step's after
    it (on the cache the ring wrote) within TP_LOGIT_TOL of one card's,
    every rank's #3 at 0 and #1 once a layer per decode step, and the prompt
    served."""
    t0 = time.perf_counter()
    prompt, want_p, want_d = ref["prompt"], ref["prefill"], ref["decode"]
    one_prefill_s, one_launches, one_toks = ref["prefill_s"], ref["launches"], ref["tokens"]
    L = TP_MODEL["num_hidden_layers"]
    if one_launches["flash_prefill_attention"] != L:
        raise SmokeError(f"serve_tp/cp: one card's prefill launched {one_launches}")

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(SERVE_DIR, exist_ok=True)
    fport = free_port()
    env = dict(os.environ)
    logs = {n: open(os.path.join(SERVE_DIR, f"cp_{n}.log"), "w") for n in ("fabric", "node1")}
    server = subprocess.Popen([sys.executable, "-m", "dynamo_tpu_torch.fabric.server", "--host",
                               "127.0.0.1", "--port", str(fport)], cwd=here, env=env,
                              stdout=logs["fabric"], stderr=subprocess.STDOUT)
    node1 = None
    try:
        wait_port(fport, 30, server)
        node1 = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cp-node"], cwd=here,
            env={**env, "DYN_FABRIC_ADDR": f"127.0.0.1:{fport}", "DYN_NUM_NODES": str(CP),
                 "DYN_NODE_RANK": "1"}, stdout=logs["node1"], stderr=subprocess.STDOUT)
        got = asyncio.run(cp_grid_leader(torch, np, fport, prompt, Context))
        node1.wait(120)
    finally:
        for proc in (node1, server):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs.values():
            f.close()
    if node1.returncode != 0:
        raise SmokeError(f"serve_tp/cp: node 1 ended {node1.returncode} (log "
                         f"{os.path.join(SERVE_DIR, 'cp_node1.log')})")
    errs = {"prefill": rel_logit_err(torch, got["prefill"], want_p[None]),
            "decode": rel_logit_err(torch, got["decode"], want_d)}
    if got["sp"] != CP or max(errs.values()) > TP_LOGIT_TOL:
        raise SmokeError(f"serve_tp/cp: sp {got['sp']}, logits {errs} of the row's max apart from "
                         f"one card's (tol {TP_LOGIT_TOL})")
    rank_launch_check("serve_tp/cp logits", got["logit_ranks"], {"paged_decode_attention": L})
    (toks, reason, ttft), = got["served"]
    st = got["stats"]
    if reason is not FinishReason.LENGTH or len(toks) != CP_OUT or st["prefills"] != 1:
        raise SmokeError(f"serve_tp/cp: {len(toks)} tokens, {reason}, stats {st}")
    rank_launch_check("serve_tp/cp serve", got["serve_ranks"],
                      {"paged_decode_attention": L * (st["decode_steps"] + st["mixed_steps"])})
    same = next((j for j, (a, b) in enumerate(zip(toks, one_toks)) if a != b), len(toks))
    res = {
        "prompt": CP_PROMPT, "sp": CP, "logit_max_rel_err": errs, "bringup_s": got["bringup_s"],
        "prefill_s_cp": got["prefill_s"], "prefill_s_one_card": one_prefill_s,
        "ttft_s_served": ttft, "serve_s": got["serve_s"], "stats": st,
        "tokens_agree_with_one_card_for": same,
        "logit_rank_stats": got["logit_ranks"], "serve_rank_stats": got["serve_ranks"],
        "leg_s": time.perf_counter() - t0,
    }
    log(f"serve_tp/cp: two nodes met through the fabric barrier in {got['bringup_s']:.1f} s; ring "
        f"prefill of {CP_PROMPT} tokens over sp={CP} {got['prefill_s']:.2f} s (one card's #3 "
        f"{one_prefill_s:.2f} s); logits within {errs['prefill']:.4f} (prefill) / "
        f"{errs['decode']:.4f} (the decode step on the ring's cache) of one card's row max; per "
        f"rank #3 0, #1 {L}; collectives "
        f"{[round(r['collective_s'], 2) for r in got['logit_ranks']]} s, staged "
        f"{[r['staged_bytes'] for r in got['logit_ranks']]} B; served {CP_OUT} tokens (TTFT "
        f"{ttft:.2f} s), equal to one card's for the first {same} ({card})")
    print(json.dumps({"serve_tp_cp": {k: v for k, v in res.items()}, "card": card}), flush=True)
    return res


def cp_node_main() -> int:
    """Node 1 of serve_tp's CP leg (``--cp-node``, started by serve_tp_cp
    with DYN_FABRIC_ADDR, DYN_NUM_NODES and DYN_NODE_RANK): its lease, its
    rank built through the rendezvous, then the leader's steps replayed
    until its engine closes."""
    import torch  # noqa: F401 -- the card's context before the group forms

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.fabric.client import FabricClient
    from dynamo_tpu_torch.parallel.multinode import MultiNodeConfig

    async def run():
        fabric = await FabricClient.connect(os.environ["DYN_FABRIC_ADDR"])
        lease = await fabric.lease_grant(CP_LEASE_TTL_S)

        async def keepalive():
            while True:
                await asyncio.sleep(CP_LEASE_TTL_S / 3)
                await fabric.lease_keepalive(lease)

        ka = asyncio.get_running_loop().create_task(keepalive())
        handle = await asyncio.get_running_loop().run_in_executor(None, lambda: build_torch_engine(
            TP_MODEL, device="cuda", context_parallel_size=CP, tp_backend="gloo",
            multinode=MultiNodeConfig.from_env(), fabric=fabric, lease_id=lease, **CP_KW))
        stats = await handle.serve_async()
        print(json.dumps({"cp_node": {"ranks": len(stats), "launches": stats[1]["launches"]}}),
              flush=True)
        ka.cancel()
        await fabric.close()

    asyncio.run(run())
    return 0


def phase_serve_tp(torch, np, card: str) -> dict:
    """Tensor-parallel serving on one card: build_torch_engine(
    tensor_parallel_size=2, tp_backend="gloo", tp_devices=["cuda:0",
    "cuda:0"], fused_decode=True) at full width on the default path, bf16
    then int8 weights + int8 KV (four of serve's requests each); then a
    one-rank NCCL group running fused steps with DYN_COLLECTIVE_OVERLAP=1
    (the ring with zero hops). Two ranks on one card over gloo check
    correctness; their times say nothing of collective speed across cards."""
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.ops import kernels
    from dynamo_tpu_torch.protocols.common import (
        Context, FinishReason, PreprocessedRequest, SamplingOptions, StopConditions,
    )

    every = make_requests(np, PreprocessedRequest, SamplingOptions, StopConditions)
    reqs = [every[i] for i in TP_REQUESTS]
    def spec_and_cp_reference(one, engine):
        # the mm leg first: closing the spec leg's engines stops the followers
        return {"mm": serve_tp_mm(torch, np, card, one, engine),
                "spec": serve_tp_spec(torch, np, card, one, engine, Context, FinishReason),
                "cp_reference": cp_reference(torch, np, one, Context)}

    legs = {"bf16": serve_tp_leg(torch, np, card, False, reqs, Context, FinishReason,
                                 after=spec_and_cp_reference)}
    done = legs["bf16"].pop("after")
    legs["spec"] = done["spec"]
    legs["mm"] = done["mm"]
    gc.collect()
    torch.cuda.empty_cache()
    legs["int8"] = serve_tp_leg(torch, np, card, True, reqs, Context, FinishReason)
    gc.collect()
    torch.cuda.empty_cache()
    legs["cp"] = serve_tp_cp(torch, np, card, done["cp_reference"], Context, FinishReason)
    gc.collect()
    torch.cuda.empty_cache()
    disagg = serve_tp_disagg(torch, np, card, every, Context, FinishReason)
    gc.collect()
    torch.cuda.empty_cache()

    # one rank over NCCL, the ring tail from DYN_COLLECTIVE_OVERLAP
    os.environ["DYN_COLLECTIVE_OVERLAP"] = "1"
    try:
        engine = build_torch_engine(TP_MODEL, device="cuda", tensor_parallel_size=1,
                                    tp_backend="nccl", max_batch=8, max_model_len=MAX_MODEL_LEN,
                                    seed=0, fused_decode=True, spec_k=0, num_blocks=TP_BLOCKS)
    finally:
        del os.environ["DYN_COLLECTIVE_OVERLAP"]
    runner = engine.runner
    if runner.group.backend != "nccl" or not runner.config.collective_overlap:
        raise SmokeError(f"serve_tp/nccl: group {runner.group}, overlap "
                         f"{runner.config.collective_overlap}")
    runner.rank_stats(reset=True)
    kernels.reset_launch_counts()
    packed, (toks, pos, table, slots) = step_inputs(np, runner, [list(range(1, 40))])
    runner.fetch_sample(runner.prefill_packed_arrays(**packed))
    tok = runner.fetch_sample(runner.decode(toks, pos, table, slots, np.zeros(1, np.float32),
                                            np.ones(1, np.float32), np.zeros(1, np.int64)))[0]
    (st,) = runner.rank_stats()
    asyncio.run(engine.close())
    L = TP_MODEL["num_hidden_layers"]
    want = {**dict.fromkeys(kernels.KERNELS, 0), "paged_decode_attention": L,
            "fused_qkv_rope": L, "fused_attn_out_partial": L}
    if st["launches"] != want or not 0 <= int(tok[0]) < LLAMA31_8B["vocab_size"]:
        raise SmokeError(f"serve_tp/nccl: launches {st['launches']} != {want}, token {tok}")
    log(f"serve_tp/nccl: one rank over NCCL ran a fused step with the ring tail (zero hops): "
        f"{L} 5p launches, token {int(tok[0])} ({card})")
    return {"legs": legs, "disagg": disagg,
            "nccl_one_rank": {"launches": st["launches"], "token": int(tok[0])}}


# ------------------------------------------------------------- serve_http

SERVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "serve_http")
# Llama-3-Instruct's chat template (tokenizer_config.json as published)
LLAMA3_CHAT_TEMPLATE = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}"
    "{% set content = '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n'"
    "+ message['content'] | trim + '<|eot_id|>' %}{% if loop.index0 == 0 %}"
    "{% set content = bos_token + content %}{% endif %}{{ content }}{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}"
)
LLAMA3_SPLIT = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
NAMED_SPECIALS = {128000: "<|begin_of_text|>", 128001: "<|end_of_text|>",
                  128006: "<|start_header_id|>", 128007: "<|end_header_id|>", 128009: "<|eot_id|>"}
SERVER_START_S = 420  # weights init + kernel loads + imports, at most
HTTP_TIMEOUT_S = 180
HTTP_STOP, HTTP_PENALIZED, HTTP_CLOSE_AFTER = 2, PENALIZED, 4


def llama3_style_tokenizer_json(n_regular: int = 128000, seed: int = 0) -> str:
    """A Llama-3-shaped tokenizer.json made here (no checkpoint's tokenizer
    is in the repository): byte-level BPE over the Llama-3 split pattern
    with ignore_merges, a TemplateProcessing BOS, ids 0-255 the byte
    alphabet, 256..n_regular-1 seeded merges that each extend a word by one
    letter, and the 256 special tokens at 128000-128255, so every id the
    model can sample decodes."""
    import random

    from dynamo_tpu_torch.tokenizer_json import bytes_to_unicode

    b2u = bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    merges = []
    letters = [b2u[b] for b in b"abcdefghijklmnopqrstuvwxyz"]
    pool = []

    def add(a, b):
        merges.append([a, b])
        vocab[a + b] = len(vocab)
        pool.append(a + b)

    for c in letters:
        add(b2u[ord(" ")], c)
    rng = random.Random(seed)
    while len(vocab) < n_regular:
        left = rng.choice(pool[-4096:] if rng.random() < 0.5 else pool)
        new = left + rng.choice(letters)
        if len(new) <= 12 and new not in vocab:
            add(left, new[-1])
    added = []
    for i in range(n_regular, LLAMA31_8B["vocab_size"]):
        name = NAMED_SPECIALS.get(i, f"<|reserved_special_token_{i - n_regular}|>")
        vocab[name] = i
        added.append({"id": i, "content": name, "single_word": False, "lstrip": False,
                      "rstrip": False, "normalized": False, "special": True})
    bos = NAMED_SPECIALS[128000]
    return json.dumps({
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT}, "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True, "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False, "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": bos, "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": bos, "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": bos, "type_id": 1}}, {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {bos: {"id": bos, "ids": [128000], "tokens": [bos]}}}]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False, "byte_fallback": False,
                  "ignore_merges": True, "vocab": vocab, "merges": merges},
    })


# the fleet phases' model (serve_http, serve_fabric, serve_kv;
# serve_trace_faults has TF_MODEL): the main phases' cut depth, so their processes start,
# prefill and ship K/V in half the time; serve_disagg_fabric (whose 256-block
# payload must pass the fabric's 512 MiB frame) and serve_ops (whose hedging
# leg is sized to the full depth's TTFT) keep 32
FLEET_MODEL = MAIN_MODEL


def write_serve_dir(config: Optional[dict] = None, directory: str = SERVE_DIR) -> str:
    """``config`` (default: the published Llama-3.1-8B config.json), the
    script's tokenizer.json and a Llama-3-style tokenizer_config.json in
    ``directory``; no weights, so the CLI serves seeded random bf16
    weights."""
    os.makedirs(directory, exist_ok=True)
    for name in os.listdir(directory):
        if name.endswith(".safetensors"):
            raise SmokeError(f"{directory} holds weights ({name}); this phase serves random ones")
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(config or LLAMA31_8B, f)
    with open(os.path.join(directory, "tokenizer.json"), "w") as f:
        f.write(llama3_style_tokenizer_json())
    with open(os.path.join(directory, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": LLAMA3_CHAT_TEMPLATE, "bos_token": NAMED_SPECIALS[128000],
                   "eos_token": NAMED_SPECIALS[128009]}, f)
    return directory


def prompt_words(tokenizer, n_tokens: int, seed: int) -> str:
    """Text of about ``n_tokens`` tokens: random vocabulary words, some of
    them glued in pairs so BPE has merging to do."""
    import random

    rng = random.Random(seed)
    words, count = [], 0
    while count < n_tokens:
        a = tokenizer.decode([rng.randrange(256 + 26, 128000)]).strip()
        if rng.random() < 0.3:
            a += tokenizer.decode([rng.randrange(256 + 26, 128000)]).strip()
        n = len(tokenizer.encode(" " + a, add_special_tokens=False).ids)
        if count + n > n_tokens:
            break
        words.append(a)
        count += n
    return " ".join(words)


_PORTS_GIVEN: set = set()


def free_port() -> int:
    """A port nothing listens on, for a server started later. It comes from
    below the kernel's ephemeral range, so the outgoing connections made
    meanwhile cannot take it (one did: a frontend started a minute after its
    port was picked found it in use); no port is handed out twice."""
    import random
    import socket

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = random.Random(os.urandom(8))
    for _ in range(1000):
        # an ephemeral range reaching down to 10000 leaves no room: bind 0
        port = rng.randrange(10000, low) if low > 11000 else 0
        if port in _PORTS_GIVEN:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            port = s.getsockname()[1]
        if port not in _PORTS_GIVEN:
            _PORTS_GIVEN.add(port)
            return port
    raise SmokeError(f"no free port below {low}")


def wait_port(port: int, timeout_s: float, proc=None) -> None:
    """Until a server accepts connections on ``port`` (raises when ``proc``
    ends first or ``timeout_s`` passes)."""
    import socket

    t0 = time.perf_counter()
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            if (proc is not None and proc.poll() is not None) or time.perf_counter() - t0 > timeout_s:
                raise SmokeError(f"nothing listens on port {port}") from None
            time.sleep(0.1)


def http_call(port: int, method: str, path: str, body=None, timeout: float = HTTP_TIMEOUT_S):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def stream_chat(port: int, body: dict, close_after: Optional[int] = None) -> dict:
    """One streamed chat completion over stdlib http.client: every SSE event
    parsed, with the time of each content chunk from the request's send;
    with ``close_after``, the socket is closed after that many chunks."""
    import http.client

    from dynamo_tpu_torch.protocols.sse import SseParser

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT_S)
    parser, events, times = SseParser(), [], []
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/v1/chat/completions", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise SmokeError(f"stream answered {resp.status}: {resp.read()[:300]!r}")
        if not resp.getheader("Content-Type", "").startswith("text/event-stream"):
            raise SmokeError(f"stream content type {resp.getheader('Content-Type')!r}")
        while True:
            line = resp.readline()
            if not line:
                break
            for ev in parser.feed(line.decode("utf-8")):
                events.append(ev)
                if ev.data and not ev.is_done() and ev.event is None:
                    d = ev.json()
                    if d.get("choices") and (d["choices"][0].get("delta") or {}).get("content"):
                        times.append(time.perf_counter() - t0)
            if close_after is not None and len(events) >= close_after:
                conn.sock.shutdown(2)
                return {"events": events}
    finally:
        conn.close()
    return summarize_stream(events, times)


def summarize_stream(events: list, times: list) -> dict:
    """Check one SSE stream's form: JSON events, a role chunk first, content
    chunks, exactly one finish reason, a usage chunk, then [DONE]."""
    if not events or not events[-1].is_done():
        raise SmokeError("stream does not end in [DONE]")
    text, finish, usage, n_lp, role = "", [], None, 0, None
    for ev in events[:-1]:
        if ev.event is not None:
            raise SmokeError(f"stream carried an {ev.event!r} event: {ev.data}")
        d = ev.json()
        if d.get("object") != "chat.completion.chunk":
            raise SmokeError(f"not a chat chunk: {d}")
        if d.get("usage"):
            usage = d["usage"]
        for ch in d.get("choices", []):
            delta = ch.get("delta") or {}
            role = role or delta.get("role")
            text += delta.get("content") or ""
            n_lp += len((ch.get("logprobs") or {}).get("content") or [])
            if ch.get("finish_reason"):
                finish.append(ch["finish_reason"])
    if role != "assistant" or len(finish) != 1 or usage is None:
        raise SmokeError(f"malformed stream: role {role!r}, finish reasons {finish}, usage {usage}")
    itl = [b - a for a, b in zip(times, times[1:])]
    return {"text": text, "finish": finish[0], "usage": usage, "logprob_tokens": n_lp,
            "ttft_s": times[0] if times else None,
            "itl_ms_mean": statistics.mean(itl) * 1e3 if itl else None}


def chat_body(content: str, max_tokens: int, **extra) -> dict:
    return {"model": "llama31-8b", "messages": [{"role": "user", "content": content}],
            "max_tokens": max_tokens, "temperature": 0, "stream": True,
            "stream_options": {"include_usage": True}, **extra}


async def engine_direct(execution, body: dict, Context) -> dict:
    """The same chat request through the port's ModelExecution in-process
    (preprocess, engine, detokenize; no HTTP), timed like the HTTP client."""
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest

    t0 = time.perf_counter()
    times, text = [], ""
    async for item in execution.chat_stream(ChatCompletionRequest.from_dict(body), Context()):
        if item.is_error():
            raise SmokeError(f"engine-direct request failed: {item.error_message()}")
        for ch in (item.data or {}).get("choices", []):
            piece = (ch.get("delta") or {}).get("content")
            if piece:
                times.append(time.perf_counter() - t0)
                text += piece
    itl = [b - a for a, b in zip(times, times[1:])]
    return {"text": text, "ttft_s": times[0], "itl_ms_mean": statistics.mean(itl) * 1e3}


LONE_PAIRS = 3  # lone requests through HTTP and engine-direct, in turns


def direct_server(model_dir: str) -> None:
    """Run in a process of its own by ``DirectProcess``: build the engine
    the server builds, print a ready line, then time each chat body read
    from stdin engine-direct (the port's ModelExecution, no HTTP) and print
    the result, one JSON line each, until stdin ends."""
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.http.service import ModelExecution
    from dynamo_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.protocols.common import Context

    mdc = ModelDeploymentCard.from_model_dir(model_dir, "llama31-8b", context_length=MAX_MODEL_LEN)
    engine = build_torch_engine(model_dir, device="cuda", max_model_len=MAX_MODEL_LEN, num_blocks=2112)
    execution = ModelExecution(mdc, engine.generate)

    async def serve():
        loop = asyncio.get_running_loop()
        try:
            print(json.dumps({"ready": True}), flush=True)
            while True:
                line = await loop.run_in_executor(None, sys.stdin.readline)
                if not line.strip():
                    return
                print(json.dumps(await engine_direct(execution, json.loads(line), Context)), flush=True)
        finally:
            await engine.close()

    asyncio.run(serve())


class DirectProcess:
    """``direct_server`` in a new process, started as the server's is and
    alive beside it, so that HTTP and engine-direct requests can be timed
    in turns and differ by the frontend, not by the process (every earlier
    phase ran in this one)."""

    def __init__(self, root: str, model_dir: str, env: dict, stderr) -> None:
        code = "import sys, chip_smoke; chip_smoke.direct_server(sys.argv[1])"
        self.proc = subprocess.Popen([sys.executable, "-c", code, model_dir], cwd=root, env=env,
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=stderr,
                                     text=True)

    def _line(self) -> dict:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(1) as pool:
            line = pool.submit(self.proc.stdout.readline).result(timeout=SERVER_START_S)
        if not line:
            raise SmokeError(f"the engine-direct process exited with {self.proc.wait(30)}")
        return json.loads(line)

    def wait_ready(self) -> None:
        self._line()

    def run(self, body: dict) -> dict:
        self.proc.stdin.write(json.dumps(body) + "\n")
        self.proc.stdin.flush()
        return self._line()

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()
                self.proc.wait(60)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait(30)


def phase_serve_http(torch, np, card: str) -> dict:
    """The CLI's HTTP server in its own process at Llama-3.1-8B width, then
    the lone request engine-direct in this process (see the docstring)."""
    import signal
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.http.service import ModelExecution
    from dynamo_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.ops import kernels
    from dynamo_tpu_torch.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.protocols.common import Context
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest

    t0 = time.perf_counter()
    model_dir = write_serve_dir(FLEET_MODEL)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    mdc = ModelDeploymentCard.from_model_dir(model_dir, "llama31-8b", context_length=MAX_MODEL_LEN)
    t_card = time.perf_counter() - t0
    pre = OpenAIPreprocessor(mdc)
    tok = pre.tokenizer
    log(f"serve_http: model dir written in {t_write:.2f} s (vocab {tok.vocab_size}); "
        f"card + tokenizer loaded in {t_card:.2f} s")
    if tok.vocab_size != LLAMA31_8B["vocab_size"]:
        raise SmokeError(f"tokenizer vocab {tok.vocab_size} != {LLAMA31_8B['vocab_size']}")

    # host time of templating + tokenizing a 2000-token prompt: cold (a new
    # tokenizer, empty word cache) and warm (the same request again)
    long_req = ChatCompletionRequest.from_dict(chat_body(prompt_words(tok, 1990, seed=99), 8))
    fresh = OpenAIPreprocessor(mdc)
    t0 = time.perf_counter()
    long_pre, _ = fresh.preprocess_chat(long_req)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    fresh.preprocess_chat(long_req)
    t_warm = time.perf_counter() - t0
    log(f"serve_http: template + tokenize of a {len(long_pre.token_ids)}-token prompt: "
        f"{t_cold * 1e3:.2f} ms cold, {t_warm * 1e3:.2f} ms warm (host; {card})")

    lone = chat_body(prompt_words(tok, 490, seed=7), 64, nvext={"ignore_eos": True})
    warm = chat_body("hello there", 4)
    # the template's own tokens around the user's text
    overhead = len(pre.preprocess_chat(ChatCompletionRequest.from_dict(chat_body("", 1)))[0].token_ids)
    contents = [prompt_words(tok, max(4, n - overhead), seed=100 + i) for i, n in enumerate(PROMPT_LENS)]
    bodies = []
    for i, (content, m) in enumerate(zip(contents, MAX_TOKENS)):
        extra = {"logprobs": True}
        if i == HTTP_STOP:
            extra["stop"] = ["e"]
        if i == HTTP_PENALIZED:
            extra.update(PENALTIES, min_tokens=MIN_TOKENS)
        bodies.append(chat_body(content, m, **extra))
    expect_prompt = [len(pre.preprocess_chat(ChatCompletionRequest.from_dict(b))[0].token_ids)
                     for b in bodies]

    port = free_port()
    log_path = os.path.join(SERVE_DIR, "server.log")
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.run", "in=http", "out=torch",
           "--model-path", model_dir, "--model-name", "llama31-8b",
           "--context-length", str(MAX_MODEL_LEN), "--num-blocks", "2112",
           "--http-host", "127.0.0.1", "--http-port", str(port)]
    log("serve_http: " + " ".join(cmd[1:]))
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out: dict = {}
    with open(log_path, "w") as logf, open(os.path.join(SERVE_DIR, "direct.log"), "w") as dlog:
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=logf, stderr=subprocess.STDOUT)
        direct = DirectProcess(root, model_dir, env, dlog)
        try:
            t0 = time.perf_counter()
            while True:
                if proc.poll() is not None:
                    raise SmokeError(f"server exited with {proc.returncode} before /health answered")
                try:
                    if http_call(port, "GET", "/health", timeout=5)[0] == 200:
                        break
                except OSError:
                    pass
                if time.perf_counter() - t0 > SERVER_START_S:
                    raise SmokeError(f"server did not answer /health within {SERVER_START_S} s")
                time.sleep(1.0)
            out["server_start_s"] = time.perf_counter() - t0
            log(f"serve_http: server up in {out['server_start_s']:.1f} s")
            st, data = http_call(port, "GET", "/v1/models")
            if st != 200 or json.loads(data)["data"][0]["id"] != "llama31-8b":
                raise SmokeError(f"/v1/models answered {st}: {data[:200]!r}")

            # the lone greedy request through HTTP and engine-direct in
            # turns (after one warm-up request each), both processes alive
            direct.wait_ready()
            stream_chat(port, warm)
            direct.run(warm)
            http_runs, direct_runs = [], []
            for k in range(LONE_PAIRS):
                for mode in (("http", "direct") if k % 2 == 0 else ("direct", "http")):
                    if mode == "http":
                        http_runs.append(stream_chat(port, lone))
                    else:
                        direct_runs.append(direct.run(lone))
            direct.close()
            for r in http_runs + direct_runs:
                if r["text"] != http_runs[0]["text"]:
                    raise SmokeError(f"lone request texts differ:\n{http_runs[0]['text']!r}\n{r['text']!r}")
            out["http_lone"] = http_runs[0]
            out["lone_pairs"] = {
                "http_ttft_ms": [r["ttft_s"] * 1e3 for r in http_runs],
                "http_itl_ms": [r["itl_ms_mean"] for r in http_runs],
                "direct_ttft_ms": [r["ttft_s"] * 1e3 for r in direct_runs],
                "direct_itl_ms": [r["itl_ms_mean"] for r in direct_runs],
            }

            # 8 concurrent streams
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(bodies)) as pool:
                results = list(pool.map(lambda b: stream_chat(port, b), bodies))
            out["concurrent_wall_s"] = time.perf_counter() - t0
            for i, (r, b, n_prompt) in enumerate(zip(results, bodies, expect_prompt)):
                u = r["usage"]
                if u["prompt_tokens"] != n_prompt:
                    raise SmokeError(f"stream {i}: prompt_tokens {u['prompt_tokens']} != {n_prompt}")
                if u["completion_tokens"] != r["logprob_tokens"] or not 0 < u["completion_tokens"] <= b["max_tokens"]:
                    raise SmokeError(f"stream {i}: usage {u} vs {r['logprob_tokens']} tokens streamed")
                if i == HTTP_STOP and "e" in r["text"]:
                    raise SmokeError(f"stream {i}: the stop string is in the text")
                if i == HTTP_PENALIZED and u["completion_tokens"] < MIN_TOKENS:
                    raise SmokeError(f"stream {i}: {u['completion_tokens']} tokens < min_tokens")
                log(f"serve_http: stream {i}: prompt {u['prompt_tokens']} tokens, "
                    f"{u['completion_tokens']} out, finish {r['finish']}, TTFT {r['ttft_s']} s")
            out["concurrent"] = [{k: r[k] for k in ("finish", "usage", "ttft_s", "itl_ms_mean",
                                                    "text")}
                                 for r in results]
            out["embeddings"] = http_embeddings(port, tok, [contents[0], contents[2]])
            out["profile"] = http_profile(port, chat_body(contents[1], 48, nvext={"ignore_eos": True}))
            # an image part to this text-only model
            st, data = http_call(port, "POST", "/v1/chat/completions", {
                "model": "llama31-8b", "max_tokens": 4, "messages": [{"role": "user", "content": [
                    {"type": "image_url", "image_url": {"url": data_url(
                        "image/png", png_bytes(np, np.zeros((8, 8, 3), np.uint8)))}},
                    {"type": "text", "text": "what is this"}]}]})
            if st != 501 or b"not_implemented" not in data:
                raise SmokeError(f"an image to the text-only server answered {st}: {data[:200]!r}")
            log("serve_http: an image part to the text-only model answered 501")

            # one non-streamed completion
            st, data = http_call(port, "POST", "/v1/completions", {
                "model": "llama31-8b", "prompt": contents[2], "max_tokens": 32, "temperature": 0,
                "stream_options": {"include_usage": True}})
            comp = json.loads(data)
            if st != 200 or comp.get("object") != "text_completion" or not comp["choices"][0].get(
                    "finish_reason") or not 0 < comp["usage"]["completion_tokens"] <= 32:
                raise SmokeError(f"non-streamed completion: {st} {data[:300]!r}")
            out["completion_usage"] = comp["usage"]

            # a stream the client closes after 4 chunks, then a request after it
            closing = chat_body(contents[1], 2000, nvext={"ignore_eos": True})
            stream_chat(port, closing, close_after=HTTP_CLOSE_AFTER)
            t0 = time.perf_counter()
            after = stream_chat(port, chat_body("after the hang up", 8))
            out["after_close_s"] = time.perf_counter() - t0
            log(f"serve_http: closed a stream after {HTTP_CLOSE_AFTER} chunks; the next request "
                f"took {out['after_close_s']:.2f} s ({after['usage']['completion_tokens']} tokens)")
        finally:
            direct.close()
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(30)
    stats = None
    with open(log_path) as f:
        for line in f:
            if line.startswith('{"exit_stats"'):
                stats = json.loads(line)["exit_stats"]
    if stats is None:
        raise SmokeError(f"the server printed no exit stats (see {log_path})")
    streamed = (sum(r["usage"]["completion_tokens"] for r in results) + out["completion_usage"][
        "completion_tokens"] + LONE_PAIRS * out["http_lone"]["usage"]["completion_tokens"] + 4 + 8)
    # the closed stream may have made a few tokens more than the 4 chunks read
    # before its lane was freed; 2000 would show a lane left running
    if stats["busy_lanes"] or stats["free_blocks"] != stats["num_blocks"] - 1 or (
            stats["generated_tokens"] > streamed + 200):
        raise SmokeError(f"the closed stream's lane was not freed: {stats}, {streamed} tokens streamed")
    out["server_exit"] = stats
    launches = stats["kernel_launches"]
    if launches["paged_decode_attention"] <= 0:
        raise SmokeError(f"the HTTP phase launched no #1: {launches}")
    # the server chunks and packs every prompt: #3 ran for the embeddings alone
    n_embed = len(out["embeddings"]["ids"])
    if launches["flash_prefill_attention"] != FLEET_MODEL["num_hidden_layers"] * n_embed:
        raise SmokeError(f"the server's #3 launches {launches['flash_prefill_attention']} != "
                         f"{FLEET_MODEL['num_hidden_layers']} x {n_embed} embeddings")
    log(f"serve_http: server kernel launches {launches}, generated {stats['generated_tokens']} tokens")

    # the lone request engine-direct in this process, the card now free
    gc.collect()
    torch.cuda.empty_cache()
    engine = build_torch_engine(model_dir, device="cuda", max_model_len=MAX_MODEL_LEN, num_blocks=2112)
    execution = ModelExecution(mdc, engine.generate)

    async def direct():
        try:
            await engine_direct(execution, warm, Context)
            kernels.reset_launch_counts()
            res = await engine_direct(execution, lone, Context)
            res["launches"] = kernels.launch_counts()
            # again with this process's long-lived objects (every earlier
            # phase's) frozen out of the garbage collector's reach: the
            # server process holds far fewer
            gc.collect()
            gc.freeze()
            try:
                res["gc_frozen"] = await engine_direct(execution, lone, Context)
            finally:
                gc.unfreeze()
            return res
        finally:
            await engine.close()

    out["direct_lone"] = asyncio.run(direct())
    # the embeddings against the plain op's embed_pooled over the same weights
    emb = out["embeddings"]
    errs = []
    for ids, vec in zip(emb["ids"], emb["vectors"]):
        want = plain_embed(torch, engine.runner, ids)
        got = torch.tensor(vec, device=want.device)
        errs.append(float((got - want).abs().max() / want.abs().max()))
    if not all(e <= MM_TOL for e in errs):
        raise SmokeError(f"serve_http: embeddings {errs} of the plain op's max apart (tol {MM_TOL})")
    log(f"serve_http: /v1/embeddings within {max(errs):.4f} of the plain op's embed_pooled; "
        f"#3 {launches['flash_prefill_attention']} on the server")
    emb["plain_rel_err"] = errs
    del emb["vectors"]
    del engine, execution
    gc.collect()
    torch.cuda.empty_cache()
    h, d = out["http_lone"], out["direct_lone"]
    f = d["gc_frozen"]
    for got in (d, f):
        if h["text"] != got["text"]:
            raise SmokeError(f"HTTP text differs from the engine's:\n{h['text']!r}\n{got['text']!r}")
    lp = out["lone_pairs"]
    med = {k: statistics.median(v) for k, v in lp.items()}
    d_itl = statistics.median(a - b for a, b in zip(lp["http_itl_ms"], lp["direct_itl_ms"]))
    d_ttft = statistics.median(a - b for a, b in zip(lp["http_ttft_ms"], lp["direct_ttft_ms"]))
    log(f"serve_http: lone greedy request ({h['usage']['prompt_tokens']} + "
        f"{h['usage']['completion_tokens']} tokens), {LONE_PAIRS} in turns, medians: HTTP TTFT "
        f"{med['http_ttft_ms']:.2f} ms, ITL {med['http_itl_ms']:.2f} ms; engine-direct in its own "
        f"process TTFT {med['direct_ttft_ms']:.2f} ms, ITL {med['direct_itl_ms']:.2f} ms; "
        f"HTTP - direct per pair (median) TTFT {d_ttft:.2f} ms, ITL {d_itl:.2f} ms; ITL ranges "
        f"HTTP {min(lp['http_itl_ms']):.2f}-{max(lp['http_itl_ms']):.2f}, direct "
        f"{min(lp['direct_itl_ms']):.2f}-{max(lp['direct_itl_ms']):.2f} ms; engine-direct in this "
        f"process {d['ttft_s'] * 1e3:.2f} / {d['itl_ms_mean']:.2f} ms (garbage collector frozen: "
        f"{f['ttft_s'] * 1e3:.2f} / {f['itl_ms_mean']:.2f} ms); texts identical ({card})")
    print(json.dumps({"serve_http": {
        "card": card, "tokenize_template_ms": {"cold": t_cold * 1e3, "warm": t_warm * 1e3,
                                               "prompt_tokens": len(long_pre.token_ids)},
        "http_lone": {k: h[k] for k in ("ttft_s", "itl_ms_mean", "usage")},
        "direct_lone": {k: d[k] for k in ("ttft_s", "itl_ms_mean", "launches")},
        "direct_lone_gc_frozen": {k: f[k] for k in ("ttft_s", "itl_ms_mean")},
        "lone_pairs": lp, "lone_medians": med,
        "lone_http_minus_direct_ms": {"ttft": d_ttft, "itl": d_itl},
        "decode_launches_server": launches["paged_decode_attention"],
        **{k: out[k] for k in ("server_start_s", "concurrent_wall_s", "concurrent",
                               "completion_usage", "after_close_s", "server_exit",
                               "embeddings", "profile")},
    }}), flush=True)
    return out


def http_embeddings(port: int, tok, texts: list) -> dict:
    """POST /v1/embeddings with two inputs: a vector of the hidden size
    each, finite, the two different; ``usage`` counts their tokens."""
    import math

    ids = [tok.encode(t).ids for t in texts]
    t0 = time.perf_counter()
    st, data = http_call(port, "POST", "/v1/embeddings", {"model": "llama31-8b", "input": texts})
    ms = (time.perf_counter() - t0) * 1e3
    if st != 200:
        raise SmokeError(f"/v1/embeddings answered {st}: {data[:300]!r}")
    doc = json.loads(data)
    vecs = [d["embedding"] for d in doc["data"]]
    if len(vecs) != 2 or any(len(v) != HIDDEN or not all(map(math.isfinite, v)) for v in vecs) or (
            vecs[0] == vecs[1]) or doc["usage"]["prompt_tokens"] != sum(map(len, ids)):
        raise SmokeError(f"/v1/embeddings: {[len(v) for v in vecs]} floats, usage {doc['usage']}")
    log(f"serve_http: /v1/embeddings of {[len(i) for i in ids]} tokens answered in {ms:.1f} ms")
    return {"ms": ms, "tokens": [len(i) for i in ids], "ids": ids, "vectors": vecs,
            "usage": doc["usage"]}


def http_profile(port: int, body: dict) -> dict:
    """GET /debug/profile?seconds=1 while a request streams: 200, then 409
    on a second call; once the window closes its trace holds the card's
    kernels and the engine's dispatch labels."""
    prof_dir = os.path.join(SERVE_DIR, "profile")
    with ThreadPoolExecutor(1) as pool:
        streaming = pool.submit(stream_chat, port, body)
        time.sleep(0.2)
        st1, d1 = http_call(port, "GET", f"/debug/profile?seconds=1&dir={prof_dir}")
        st2, d2 = http_call(port, "GET", "/debug/profile?seconds=1")
        streaming.result()
    if st1 != 200 or st2 != 409:
        raise SmokeError(f"/debug/profile answered {st1} then {st2}: {d1[:200]!r} {d2[:200]!r}")
    trace_path = os.path.join(json.loads(d1)["profile_dir"], "trace.json")
    t0 = time.perf_counter()
    while not os.path.exists(trace_path):
        if time.perf_counter() - t0 > 60:
            raise SmokeError(f"the profile window wrote no {trace_path}")
        time.sleep(0.5)
    time.sleep(1.0)  # the exporter's last bytes
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    cats = collections.Counter(e.get("cat") for e in events)
    labels = sorted({e["name"] for e in events if e.get("cat") == "user_annotation"})
    dispatches = [n for n in labels if n.split("@")[0] in DISPATCH_LABELS]
    if not cats.get("kernel") or not dispatches:
        raise SmokeError(f"the profile trace holds {dict(cats)} and annotations {labels}")
    log(f"serve_http: /debug/profile 200 then 409; the window's trace holds {cats['kernel']} "
        f"kernel events and the dispatch labels {dispatches}")
    return {"kernel_events": cats["kernel"], "dispatch_labels": dispatches,
            "bytes": os.path.getsize(trace_path)}


# the engine's dispatch labels (TorchEngine._device), which profile windows name
DISPATCH_LABELS = ("decode", "decode_multi", "prefill", "prefill_packed", "prefill_chunk",
                   "mixed_step", "spec_verify", "prefill_mm", "embed")


# ------------------------------------------------------------ serve_fabric
#
# The port as a distributed deployment: the fabric server, two TorchEngine
# workers and an out=dyn frontend, each a process of its own on cuda:0.

FABRIC_BLOCKS = 2048  # per worker: two 8B workers (16.1 GB of weights each) share the card
FABRIC_TTL_S = 4.0  # DYN_LEASE_TTL_S: keepalives every 1.33 s
JANITOR_S = 0.5  # the fabric server's expiry pass
POLL_S = 0.25  # this script's discovery poll: a 50 ms sleep, a connect and a read
MIGRATE_TOKENS = 256
MIGRATE_KILL_AFTER = 48  # tokens the client has read when the worker is killed
SURVIVOR_REQUESTS = 4
FRAME_REPS = 20000


def codec_frame_us() -> dict:
    """Host microseconds per streamed token frame through the port's stdlib
    codec, as the request plane builds one (the engine's output dict with
    its fencing stamp, packed into an Annotated, framed) and reads it back."""
    from dynamo_tpu_torch.fabric import mpack, wire

    item = {"data": {"token_ids": [91234], "index": 0, "log_probs": [-0.6931471805599453],
                     "stamp": {"iid": 0x6B8B4567327B, "ep": 0x6B8B4567327B}}}
    header = {"t": "data"}
    t0 = time.perf_counter()
    for _ in range(FRAME_REPS):
        frame = wire.pack([header, mpack.packb(item)])
    t_enc = (time.perf_counter() - t0) / FRAME_REPS
    body = frame[5:]
    t0 = time.perf_counter()
    for _ in range(FRAME_REPS):
        _, payload = mpack.unpackb(body)
        got = mpack.unpackb(payload)
    t_dec = (time.perf_counter() - t0) / FRAME_REPS
    if got != item:
        raise SmokeError(f"codec round trip changed the frame: {got}")
    return {"encode_us": t_enc * 1e6, "decode_us": t_dec * 1e6,
            "frame_us": (t_enc + t_dec) * 1e6, "frame_bytes": len(frame)}


class LogTail:
    """A process's log file, read for the JSON lines it prints."""

    def __init__(self, path: str) -> None:
        self.path = path

    def json_lines(self, key: str) -> list:
        with open(self.path) as f:
            return [json.loads(line)[key] for line in f if line.startswith('{"' + key + '"')]

    def wait_json(self, key: str, n: int, proc, timeout: float) -> list:
        t0 = time.perf_counter()
        while True:
            got = self.json_lines(key)
            if len(got) >= n:
                return got
            if proc.poll() is not None:
                raise SmokeError(f"{self.path}: exited with {proc.returncode} before printing {key}")
            if time.perf_counter() - t0 > timeout:
                raise SmokeError(f"{self.path}: no {key} line within {timeout} s")
            time.sleep(0.02)


def stream_tokens(port: int, body: dict, marks: dict, path: str = "/v1/chat/completions",
                  headers: dict | None = None) -> dict:
    """A streamed chat completion (or, with ``path``, completion) with
    logprobs: every token (the logprob entries' token strings) and its
    arrival on time.perf_counter's clock, and the streamed text;
    ``marks["n"]`` is kept at the number of tokens read so far."""
    import http.client

    from dynamo_tpu_torch.protocols.sse import SseParser

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT_S)
    parser, tokens, times, usage, finish, errors = SseParser(), [], [], None, [], []
    text = ""
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        if resp.status != 200:
            raise SmokeError(f"stream {headers or ''} answered {resp.status}: {resp.read()[:300]!r}")
        while True:
            line = resp.readline()
            if not line:
                break
            for ev in parser.feed(line.decode("utf-8")):
                if ev.is_done():
                    continue
                if ev.event is not None:
                    errors.append(ev.data)
                    continue
                d = ev.json()
                usage = d.get("usage") or usage
                for ch in d.get("choices", []):
                    text += (ch.get("delta") or {}).get("content") or ch.get("text") or ""
                    lp = ch.get("logprobs") or {}
                    # chat: one entry per token; completions: a list of strings
                    for t in [e["token"] for e in lp.get("content") or []] or lp.get("tokens") or []:
                        tokens.append(t)
                        times.append(time.perf_counter())
                    if ch.get("finish_reason"):
                        finish.append(ch["finish_reason"])
                marks["n"] = len(tokens)
    finally:
        conn.close()
    if errors:
        raise SmokeError(f"the stream carried error events: {errors}")
    return {"tokens": tokens, "times": times, "usage": usage, "finish": finish, "text": text}


def first_log_time(path: str, needle: str) -> float:
    """Epoch seconds of the first line of a process's log (the CLI's
    ``%(asctime)s`` format, local time, ms resolution) holding ``needle``."""
    with open(path) as f:
        for line in f:
            if needle in line:
                stamp, ms = line[:23].split(",")
                return time.mktime(time.strptime(stamp, "%Y-%m-%d %H:%M:%S")) + int(ms) / 1e3
    raise SmokeError(f"{path}: no line with {needle!r}")


def fabric_instances(fport: int) -> dict:
    """The endpoint's live instances in the fabric: {instance id: key}."""
    from dynamo_tpu_torch.fabric.client import FabricClient

    async def get():
        c = await FabricClient.connect(f"127.0.0.1:{fport}")
        try:
            keys = await c.kv_get_prefix("instances/dynamo/backend/generate:")
            return {int(k.rsplit(":", 1)[1], 16): k for k in keys}
        finally:
            await c.close()

    return asyncio.run(get())


def phase_serve_fabric(torch, np, card: str, http_lone_text: Optional[str] = None) -> dict:
    """The fabric server, two workers and an out=dyn frontend as processes
    on this card, beside an engine-direct process (see the docstring)."""
    import signal
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest

    t_phase = time.perf_counter()
    model_dir = write_serve_dir(FLEET_MODEL)
    mdc = ModelDeploymentCard.from_model_dir(model_dir, "llama31-8b", context_length=MAX_MODEL_LEN)
    pre = OpenAIPreprocessor(mdc)
    tok = pre.tokenizer
    codec = codec_frame_us()
    log(f"serve_fabric: codec {codec['frame_us']:.2f} us per token frame (encode "
        f"{codec['encode_us']:.2f} + decode {codec['decode_us']:.2f}; {codec['frame_bytes']} bytes; "
        f"host of this process, {card})")
    lone = chat_body(prompt_words(tok, 490, seed=7), 64, nvext={"ignore_eos": True})
    warm = chat_body("hello there", 4)
    overhead = len(pre.preprocess_chat(ChatCompletionRequest.from_dict(chat_body("", 1)))[0].token_ids)
    contents = [prompt_words(tok, max(4, n - overhead), seed=100 + i) for i, n in enumerate(PROMPT_LENS)]
    bodies = []
    for i, (content, m) in enumerate(zip(contents, MAX_TOKENS)):
        extra = {"logprobs": True}
        if i == HTTP_STOP:
            extra["stop"] = ["e"]
        if i == HTTP_PENALIZED:
            extra.update(PENALTIES, min_tokens=MIN_TOKENS)
        bodies.append(chat_body(content, m, **extra))
    expect_prompt = [len(pre.preprocess_chat(ChatCompletionRequest.from_dict(b))[0].token_ids)
                     for b in bodies]
    migrate = chat_body(prompt_words(tok, 300, seed=11), MIGRATE_TOKENS, logprobs=True,
                        nvext={"ignore_eos": True})

    root = os.path.dirname(os.path.abspath(__file__))
    fport, hport = free_port(), free_port()
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
               DYN_FABRIC_ADDR=f"127.0.0.1:{fport}", DYN_LEASE_TTL_S=str(FABRIC_TTL_S))
    py = sys.executable
    cmds = {
        "fabric": [py, "-m", "dynamo_tpu_torch.fabric.server", "--host", "127.0.0.1", "--port", str(fport)],
        **{f"worker{i}": [py, "-m", "dynamo_tpu_torch.run", "in=dyn://dynamo.backend.generate", "out=torch",
                          "--model-path", model_dir, "--model-name", "llama31-8b",
                          "--context-length", str(MAX_MODEL_LEN), "--num-blocks", str(FABRIC_BLOCKS)]
           for i in range(2)},
        "frontend": [py, "-m", "dynamo_tpu_torch.run", "in=http", "out=dyn", "--router-mode", "round_robin",
                     "--http-host", "127.0.0.1", "--http-port", str(hport)],
    }
    for name in ("worker0", "frontend"):
        log("serve_fabric: " + " ".join(cmds[name][1:]))
    procs, logs, files = {}, {}, []
    out: dict = {"card": card, "codec": codec}
    direct = None
    try:
        for name, cmd in cmds.items():
            path = os.path.join(SERVE_DIR, f"fabric_{name}.log")
            f = open(path, "w")
            files.append(f)
            logs[name] = LogTail(path)
            procs[name] = subprocess.Popen(cmd, cwd=root, env=env, stdout=f, stderr=subprocess.STDOUT)
            if name == "fabric":
                time.sleep(1.0)
        dlog = open(os.path.join(SERVE_DIR, "fabric_direct.log"), "w")
        files.append(dlog)
        direct = DirectProcess(root, model_dir, dict(os.environ, PYTHONPATH=env["PYTHONPATH"]), dlog)
        t0 = time.perf_counter()
        workers = [f"worker{i}" for i in range(2)]
        iid = {w: logs[w].wait_json("worker", 1, procs[w], SERVER_START_S)[0]["instance_id"] for w in workers}
        while True:
            for name, p in procs.items():
                if p.poll() is not None:
                    raise SmokeError(f"{name} exited with {p.returncode} (see {logs[name].path})")
            try:
                st, data = http_call(hport, "GET", "/v1/models", timeout=5)
                if st == 200 and json.loads(data)["data"] and len(fabric_instances(fport)) == 2:
                    break
            except OSError:
                pass
            if time.perf_counter() - t0 > SERVER_START_S:
                raise SmokeError("the fabric deployment did not come up")
            time.sleep(0.5)
        out["start_s"] = time.perf_counter() - t0
        log(f"serve_fabric: fabric, 2 workers ({', '.join(f'{w} {iid[w]:x}' for w in workers)}) and "
            f"the frontend up in {out['start_s']:.1f} s")
        log(f"serve_fabric: device memory held by this process {torch.cuda.memory_allocated() / 1e9:.2f} GB")

        # the lone greedy request through the fabric and engine-direct, in
        # turns, after warm-ups (round robin: the fabric runs alternate workers)
        direct.wait_ready()
        for _ in range(2):
            stream_chat(hport, warm)
        direct.run(warm)
        fab_runs, direct_runs = [], []
        for k in range(LONE_PAIRS):
            for mode in (("fabric", "direct") if k % 2 == 0 else ("direct", "fabric")):
                if mode == "fabric":
                    fab_runs.append(stream_chat(hport, lone))
                else:
                    direct_runs.append(direct.run(lone))
        direct.close()
        texts = {r["text"] for r in fab_runs + direct_runs}
        if len(texts) != 1:
            raise SmokeError(f"lone request texts differ through the fabric and engine-direct: {texts}")
        if http_lone_text is not None and http_lone_text not in texts:
            raise SmokeError(f"the fabric's lone text differs from serve_http's:\n{http_lone_text!r}\n{texts}")
        lp = {"fabric_ttft_ms": [r["ttft_s"] * 1e3 for r in fab_runs],
              "fabric_itl_ms": [r["itl_ms_mean"] for r in fab_runs],
              "direct_ttft_ms": [r["ttft_s"] * 1e3 for r in direct_runs],
              "direct_itl_ms": [r["itl_ms_mean"] for r in direct_runs]}
        med = {k: statistics.median(v) for k, v in lp.items()}
        d_ttft = statistics.median(a - b for a, b in zip(lp["fabric_ttft_ms"], lp["direct_ttft_ms"]))
        d_itl = statistics.median(a - b for a, b in zip(lp["fabric_itl_ms"], lp["direct_itl_ms"]))
        out.update(lone_pairs=lp, lone_medians=med, lone_fabric_minus_direct_ms={"ttft": d_ttft, "itl": d_itl})
        log(f"serve_fabric: lone greedy request, {LONE_PAIRS} in turns, medians: fabric TTFT "
            f"{med['fabric_ttft_ms']:.2f} ms, ITL {med['fabric_itl_ms']:.2f} ms; engine-direct TTFT "
            f"{med['direct_ttft_ms']:.2f} ms, ITL {med['direct_itl_ms']:.2f} ms; fabric - direct per pair "
            f"(median) TTFT {d_ttft:.2f} ms, ITL {d_itl:.2f} ms; texts identical"
            f"{' (and to serve_http)' if http_lone_text is not None else ''} ({card})")

        # serve_http's 8 concurrent streams and a non-streamed completion
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(bodies)) as pool:
            results = list(pool.map(lambda b: stream_chat(hport, b), bodies))
        out["concurrent_wall_s"] = time.perf_counter() - t0
        for i, (r, b, n_prompt) in enumerate(zip(results, bodies, expect_prompt)):
            u = r["usage"]
            if u["prompt_tokens"] != n_prompt:
                raise SmokeError(f"stream {i}: prompt_tokens {u['prompt_tokens']} != {n_prompt}")
            if u["completion_tokens"] != r["logprob_tokens"] or not 0 < u["completion_tokens"] <= b["max_tokens"]:
                raise SmokeError(f"stream {i}: usage {u} vs {r['logprob_tokens']} tokens streamed")
            if i == HTTP_STOP and "e" in r["text"]:
                raise SmokeError(f"stream {i}: the stop string is in the text")
            if i == HTTP_PENALIZED and u["completion_tokens"] < MIN_TOKENS:
                raise SmokeError(f"stream {i}: {u['completion_tokens']} tokens < min_tokens")
        out["concurrent"] = [{k: r[k] for k in ("finish", "usage", "ttft_s", "itl_ms_mean")} for r in results]
        st, data = http_call(hport, "POST", "/v1/completions", {
            "model": "llama31-8b", "prompt": contents[2], "max_tokens": 32, "temperature": 0,
            "stream_options": {"include_usage": True}})
        comp = json.loads(data)
        if st != 200 or comp.get("object") != "text_completion" or not 0 < comp["usage"]["completion_tokens"] <= 32:
            raise SmokeError(f"non-streamed completion through the fabric: {st} {data[:300]!r}")
        log(f"serve_fabric: 8 concurrent streams in {out['concurrent_wall_s']:.2f} s "
            f"({sum(r['usage']['completion_tokens'] for r in results)} tokens), a non-streamed "
            f"completion of {comp['usage']['completion_tokens']} tokens")

        def worker_stats(names) -> dict:
            """Each worker's stats line, printed on SIGUSR1."""
            seen = {w: len(logs[w].json_lines("worker_stats")) for w in names}
            for w in names:
                procs[w].send_signal(signal.SIGUSR1)
            return {w: logs[w].wait_json("worker_stats", seen[w] + 1, procs[w], 30)[-1] for w in names}

        stats = worker_stats(workers)
        for w in workers:
            s = stats[w]
            if s["generated_tokens"] <= 0 or s["kernel_launches"]["paged_decode_attention"] <= 0:
                raise SmokeError(f"{w} served nothing or launched no #1: {s}")
        out["worker_stats_before_kill"] = stats
        log("serve_fabric: both workers served; #1 launches "
            + ", ".join(f"{w} {stats[w]['kernel_launches']['paged_decode_attention']}" for w in workers))

        # migration: the unfaulted stream, then the same one with its worker
        # SIGKILLed after MIGRATE_KILL_AFTER tokens
        base = stream_tokens(hport, migrate, {})
        if len(base["tokens"]) != MIGRATE_TOKENS:
            raise SmokeError(f"the unfaulted stream gave {len(base['tokens'])} tokens")
        marks = {"n": 0}
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(stream_tokens, hport, migrate, marks)
            t_wait = time.perf_counter()
            while marks["n"] < MIGRATE_KILL_AFTER:
                if fut.done():
                    fut.result()
                    raise SmokeError("the migrating stream ended before the kill")
                if time.perf_counter() - t_wait > HTTP_TIMEOUT_S:
                    raise SmokeError("the migrating stream did not start")
                time.sleep(0.002)
            busy = worker_stats(workers)
            serving = [w for w in workers if busy[w]["busy_lanes"]]
            if len(serving) != 1:
                raise SmokeError(f"expected one worker serving the stream: {busy}")
            victim = serving[0]
            survivor = next(w for w in workers if w != victim)
            n_cut = marks["n"]
            t_kill, t_kill_wall = time.perf_counter(), time.time()
            procs[victim].send_signal(signal.SIGKILL)
            procs[victim].wait(30)
            got = fut.result(timeout=HTTP_TIMEOUT_S)
        t_gone = None
        while t_gone is None:
            if iid[victim] not in fabric_instances(fport):
                t_gone = time.perf_counter()
            elif time.perf_counter() - t_kill > FABRIC_TTL_S + 10:
                raise SmokeError(f"the killed instance {iid[victim]:x} stayed in discovery")
            else:
                time.sleep(0.05)
        toks = got["tokens"]
        cut = sum(1 for t in got["times"] if t < t_kill)
        if toks[:cut] != base["tokens"][:cut]:
            raise SmokeError("the migrated stream's prefix differs from the unfaulted run")
        if len(toks) != MIGRATE_TOKENS or got["usage"]["completion_tokens"] != MIGRATE_TOKENS or (
                got["finish"] != ["length"]):
            raise SmokeError(f"the migrated stream has {len(toks)} tokens, usage {got['usage']}, "
                             f"finish {got['finish']}")
        agree = sum(a == b for a, b in zip(toks[cut:], base["tokens"][cut:]))
        resumed = [t for t in got["times"] if t >= t_kill]
        gone_s = t_gone - t_kill
        mig = {"victim": victim, "read_at_kill": n_cut, "prefix_tokens": cut,
               "tail_agree": agree, "tail_tokens": MIGRATE_TOKENS - cut,
               "tail_agree_share": agree / max(1, MIGRATE_TOKENS - cut),
               "first_diverging": next((i for i, (a, b) in enumerate(zip(toks, base["tokens"])) if a != b), None),
               "kill_to_first_resumed_ms": (resumed[0] - t_kill) * 1e3 if resumed else None,
               "kill_to_detect_ms": (first_log_time(logs["frontend"].path, "failed mid-stream")
                                     - t_kill_wall) * 1e3,
               "kill_to_stream_end_s": got["times"][-1] - t_kill,
               "kill_to_discovery_gone_s": gone_s}
        out["migration"] = mig
        if gone_s > FABRIC_TTL_S + JANITOR_S + POLL_S:
            raise SmokeError(f"the killed instance left discovery after {gone_s:.2f} s (TTL "
                             f"{FABRIC_TTL_S} s + the janitor's {JANITOR_S} s + the poll's {POLL_S} s)")
        log(f"serve_fabric: SIGKILL of {victim} after {n_cut} tokens read: stream completed "
            f"({MIGRATE_TOKENS} tokens, prefix of {cut} equal to the unfaulted run); tail agreement "
            f"{agree}/{MIGRATE_TOKENS - cut} ({mig['tail_agree_share']:.3f}); kill -> the frontend's "
            f"failure log {mig['kill_to_detect_ms']:.1f} ms (wall clock, ms resolution), -> first resumed token "
            f"{mig['kill_to_first_resumed_ms']:.1f} ms, -> stream end {mig['kill_to_stream_end_s']:.2f} s, "
            f"-> gone from discovery {gone_s:.2f} s (TTL {FABRIC_TTL_S} s) ({card})")

        # the next requests all land on the survivor
        time.sleep(0.2)  # the frontend's watch applies the delete
        # (the first a fresh prompt as long as the replay's: its TTFT is what
        # the replay's prefill and first horizon cost, through the fabric)
        before = worker_stats([survivor])[survivor]["generated_tokens"]
        n_after, ttfts = 0, []
        for k in range(SURVIVOR_REQUESTS):
            body = (chat_body(prompt_words(tok, 300 + cut, seed=12), 8, nvext={"ignore_eos": True})
                    if k == 0 else chat_body(f"request {k} after the kill", 8))
            r = stream_chat(hport, body)
            n_after += r["usage"]["completion_tokens"]
            ttfts.append(r["ttft_s"] * 1e3)
        after = worker_stats([survivor])[survivor]["generated_tokens"]
        if after - before != n_after:
            raise SmokeError(f"the survivor generated {after - before} tokens for {n_after} streamed")
        mig["replay_length_ttft_ms"] = ttfts[0]
        log(f"serve_fabric: the next {SURVIVOR_REQUESTS} requests ({n_after} tokens) all on {survivor}; "
            f"a fresh prompt of the replay's length took {ttfts[0]:.1f} ms to its first token ({card})")

        # SIGTERM drains the survivor: its stream in flight finishes
        marks = {"n": 0}
        drain_body = chat_body("a stream in flight across the drain", 64, logprobs=True,
                               nvext={"ignore_eos": True})
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(stream_tokens, hport, drain_body, marks)
            while marks["n"] < 4 and not fut.done():
                time.sleep(0.002)
            t_term = time.perf_counter()
            procs[survivor].send_signal(signal.SIGTERM)
            t_left = None
            while t_left is None and time.perf_counter() - t_term < FABRIC_TTL_S:
                if iid[survivor] not in fabric_instances(fport):
                    t_left = time.perf_counter() - t_term
                else:
                    time.sleep(0.02)
            drained = fut.result(timeout=HTTP_TIMEOUT_S)
        rc = procs[survivor].wait(120)
        t_exit = time.perf_counter() - t_term
        if len(drained["tokens"]) != 64 or drained["finish"] != ["length"]:
            raise SmokeError(f"the stream across the drain: {len(drained['tokens'])} tokens, {drained['finish']}")
        if t_left is None or rc != 0:
            raise SmokeError(f"the drained survivor: left discovery after {t_left} s, exit code {rc}")
        exit_s = logs[survivor].json_lines("exit_stats")
        if not exit_s or exit_s[-1]["busy_lanes"] or exit_s[-1]["free_blocks"] != exit_s[-1]["num_blocks"] - 1:
            raise SmokeError(f"the drained survivor's exit stats: {exit_s}")
        out["drain"] = {"left_discovery_s": t_left, "exit_s": t_exit, "exit_stats": exit_s[-1]}
        log(f"serve_fabric: SIGTERM drained {survivor}: out of discovery in {t_left * 1e3:.0f} ms, its "
            f"stream in flight finished (64 tokens), exited 0 after {t_exit:.2f} s, every lane and block "
            f"free; #1 launches {exit_s[-1]['kernel_launches']['paged_decode_attention']}")
    finally:
        if direct is not None:
            direct.close()
        for name in ("frontend", "worker0", "worker1", "fabric"):
            p = procs.get(name)
            if p is not None and p.poll() is None:
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(30)
        for f in files:
            f.close()
    front = logs["frontend"].json_lines("exit_stats")
    if not front or front[-1]["migrations"].get("llama31-8b", 0) < 1:
        raise SmokeError(f"the frontend counted no migration: {front}")
    out["frontend_exit"] = front[-1]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"serve_fabric: frontend migrations {front[-1]['migrations']}; phase {out['phase_s']:.1f} s")
    print(json.dumps({"serve_fabric": out}), flush=True)
    return out


# ---------------------------------------------------------------- serve_kv
#
# KV-aware routing: two 8B workers with host tiers behind a KV frontend and
# a round-robin one, a standalone router beside them, then the agg graph.

KV_GROUPS = 4  # per mode, each with a fresh 1024-token prefix
KV_FOLLOWERS = 3
KV_SUFFIX = (64, 256)  # follower (and leader) suffix lengths, tokens
KV_OUT = 128  # greedy tokens out per request
KV_GAP_S = 0.3  # leader -> follower 1 -> 2 -> 3
KV_CHECK = 8  # tokens of every stream held to the dense reference
KV_HOST_GB = "4"  # DYN_KV_HOST_OFFLOAD_GB per worker
KV_FOLLOWERS_ON_LEADER = 11  # of the KV_GROUPS * KV_FOLLOWERS kv followers, at least
# the frontends' and the router's health planes keep scoring but neither
# deweight nor eject: right after the warm-up a worker's graph captures read
# as 31x the fleet's median inter-token latency (on an H100), decaying over
# tens of seconds, so that transient, not the prefix, would decide where a
# request lands (and round robin kept to one worker); serve_ops drives
# deweighting and ejection
KV_HEALTH_ENV = {"DYN_DEWEIGHT_RATIO": "1e9", "DYN_EJECT_INTERVALS": "1000000"}
KV_EJECT_RATIO = 3.0  # the health plane's default DYN_EJECT_RATIO (telemetry/health.py)


def kv_stream(port: int, ids: list, rid: str, marks: Optional[dict] = None) -> dict:
    """One streamed /v1/completions of token ids (greedy, ``KV_OUT`` tokens,
    their strings through ``logprobs``) under the request id ``rid``: the
    token strings, the time to the first one and the usage; ``marks["n"]``
    counts the tokens read so far."""
    body = {"model": "llama31-8b", "prompt": ids, "max_tokens": KV_OUT, "temperature": 0,
            "stream": True, "logprobs": 0, "nvext": {"ignore_eos": True},
            "stream_options": {"include_usage": True}}
    t0 = time.perf_counter()
    got = stream_tokens(port, body, {} if marks is None else marks, "/v1/completions",
                        {"x-request-id": rid})
    tokens, usage = got["tokens"], got["usage"]
    if len(tokens) != KV_OUT or got["finish"] != ["length"] or usage["completion_tokens"] != KV_OUT:
        raise SmokeError(f"{rid}: {len(tokens)} tokens, finish {got['finish']}, usage {usage}")
    return {"tokens": tokens, "ttft_ms": (got["times"][0] - t0) * 1e3, "usage": usage}


def health_view(port: int) -> dict:
    """A frontend's health plane from its /metrics: each worker's slowness
    score (instance id in hex) and how many are ejected."""
    import re

    text = http_call(port, "GET", "/metrics", timeout=5)[1]
    text = text.decode() if isinstance(text, bytes) else text
    scores = {m.group(1): round(float(m.group(2)), 2) for m in re.finditer(
        r'^dyn_llm_worker_health_score\{instance="([0-9a-f]+)"\} (\S+)$', text, re.M)}
    ejected = re.search(r"^dyn_llm_workers_ejected (\S+)$", text, re.M)
    return {"scores": scores, "ejected": float(ejected.group(1)) if ejected else None}


def router_calls(fport: int, bodies: list) -> list:
    """Each body's answer from the standalone router's find_best endpoint."""
    from dynamo_tpu_torch.pipeline.context import Context
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    async def go():
        drt = await DistributedRuntime.from_settings(RuntimeConfig(fabric_addr=f"127.0.0.1:{fport}"))
        try:
            client = await drt.namespace("dynamo").component("router").endpoint("find_best").client()
            await client.wait_for_instances(30.0)
            out = []
            for body in bodies:
                stream = await client.direct(body, client.instance_ids()[0], Context())
                async for item in stream:
                    if item.is_error():
                        raise SmokeError(f"the router answered an error: {item.error_message()}")
                    out.append(item.data)
                    break
                await stream.close()
            await client.close()
            return out
        finally:
            await drt.close()

    return asyncio.run(go())


def kv_reference_check(torch, runner, prompt: list, pieces: list, ids_of: dict,
                       bound: float = 0.25, n_check: int = 0, start: int = 0) -> float:
    """``reference_check`` for a stream seen through HTTP: its first
    ``n_check`` (KV_CHECK unless given) token strings name their ids through
    ``ids_of`` (string -> every id that decodes to it); where one string has
    several ids, the one the reference rates best is taken. The tokens from
    ``start`` on are held to ``bound``. Returns the largest logit gap."""
    n_check = n_check or KV_CHECK
    cands = []
    for s in pieces[:n_check]:
        c = ids_of.get(s) or ids_of.get(s.lstrip("\ufffd"))
        if not c:
            raise SmokeError(f"the streamed token {s!r} decodes from no id")
        cands.append(c)
    chosen = [c[0] if len(c) == 1 else None for c in cands]
    while True:
        gen = [x if x is not None else cands[j][0] for j, x in enumerate(chosen)]
        logits = dense_logits(torch, runner, prompt + gen)
        open_ = [j for j, x in enumerate(chosen) if x is None]
        if not open_:
            break
        row = logits[len(prompt) - 1 + open_[0]]
        chosen[open_[0]] = max(cands[open_[0]], key=lambda i: float(row[i]))
    worst = 0.0
    for j in range(start, n_check):
        row = logits[len(prompt) - 1 + j]
        gap = float(row.max() - row[chosen[j]])
        worst = max(worst, gap)
        if gap > bound:
            raise SmokeError(f"streamed token {pieces[j]!r} at step {j} is {gap:.3f} below the "
                             "reference's best logit")
    return worst


def kv_graph_leg(root: str, env: dict, card: str) -> dict:
    """``python -m dynamo_tpu_torch.serve dynamo_tpu_torch.graphs.agg`` with
    tiny-torch workers on this card and a KV frontend: a request, a worker
    SIGKILLed and restarted by the supervisor, the next request, SIGTERM."""
    import re
    import signal

    hport = free_port()
    path = os.path.join(SERVE_DIR, "kv_graph.log")
    # the graph's own fabric, on the default lease
    genv = {k: v for k, v in env.items() if k not in ("DYN_FABRIC_ADDR", "DYN_LEASE_TTL_S")}
    body = {"model": "graph-model", "prompt": "w1 w2 w3 w4 " * 8, "max_tokens": 16, "temperature": 0}
    t0 = time.perf_counter()
    with open(path, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.serve", "dynamo_tpu_torch.graphs.agg",
             "--env", f"DYN_HTTP_PORT={hport}", "--env", "DYN_HTTP_HOST=127.0.0.1",
             "--env", "DYN_GRAPH_ENGINE=tiny-torch", "--env", "DYN_ROUTER_MODE=kv"],
            cwd=root, env=genv, stdout=f, stderr=subprocess.STDOUT, start_new_session=True)
        try:
            def started(name: str) -> list:
                with open(path) as g:
                    return re.findall(rf"\[{name}\] started pid (\d+)", g.read())

            def ask() -> str:
                st, data = http_call(hport, "POST", "/v1/completions", body, timeout=60)
                if st != 200:
                    raise SmokeError(f"serve_kv/graph: answered {st}: {data[:300]!r}")
                return json.loads(data)["choices"][0]["text"]

            while True:
                if proc.poll() is not None:
                    raise SmokeError(f"serve_kv/graph: the graph exited with {proc.returncode} ({path})")
                try:
                    st, data = http_call(hport, "GET", "/v1/models", timeout=5)
                    if st == 200 and json.loads(data)["data"]:
                        break
                except OSError:
                    pass
                if time.perf_counter() - t0 > SERVER_START_S:
                    raise SmokeError("serve_kv/graph: the graph did not come up")
                time.sleep(0.25)
            up_s = time.perf_counter() - t0
            first = ask()
            pids = started("Worker-0")
            if len(pids) != 1:
                raise SmokeError(f"serve_kv/graph: Worker-0 started {len(pids)} times before the kill "
                                 f"({path})")
            os.kill(int(pids[0]), signal.SIGKILL)
            t_kill = time.perf_counter()
            while len(started("Worker-0")) <= len(pids):
                if time.perf_counter() - t_kill > 60:
                    raise SmokeError("serve_kv/graph: the supervisor did not restart Worker-0")
                time.sleep(0.1)
            restart_s = time.perf_counter() - t_kill
            second = ask()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(90)
        finally:
            # the supervisor's children too (processes on the card), whatever
            # happened to it: SIGTERM its group, then SIGKILL what is left
            for sig, wait in ((signal.SIGTERM, 60), (signal.SIGKILL, 30)):
                try:
                    os.killpg(proc.pid, sig)
                    proc.wait(wait)
                except ProcessLookupError:
                    break
                except subprocess.TimeoutExpired:
                    pass
    if rc != 0 or not first or not second:
        raise SmokeError(f"serve_kv/graph: exit code {rc}, texts {first!r} / {second!r}")
    out = {"up_s": up_s, "restart_s": restart_s, "texts_equal": first == second, "exit_code": rc}
    log(f"serve_kv/graph: agg graph (tiny-torch on the card, kv) up in {up_s:.1f} s, served; "
        f"Worker-0 SIGKILLed and restarted by the supervisor in {restart_s:.2f} s; the next request "
        f"served (same greedy text: {first == second}); exit 0 on SIGTERM ({card})")
    return out


def phase_serve_kv(torch, np, card: str) -> dict:
    """The KV-aware router on this card (see the docstring's phase 17)."""
    import signal
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.tokenizer import TokenizerWrapper

    t_phase = time.perf_counter()
    model_dir = write_serve_dir(FLEET_MODEL)
    root = os.path.dirname(os.path.abspath(__file__))
    fport, kport, rport = free_port(), free_port(), free_port()
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
               DYN_FABRIC_ADDR=f"127.0.0.1:{fport}", DYN_LEASE_TTL_S=str(FABRIC_TTL_S))
    py = sys.executable
    worker = [py, "-m", "dynamo_tpu_torch.run", "in=dyn://dynamo.backend.generate", "out=torch",
              "--model-path", model_dir, "--model-name", "llama31-8b", "--context-length",
              str(MAX_MODEL_LEN), "--num-blocks", str(FABRIC_BLOCKS)]
    front = [py, "-m", "dynamo_tpu_torch.run", "in=http", "out=dyn", "--http-host", "127.0.0.1"]
    cmds = {
        "fabric": [py, "-m", "dynamo_tpu_torch.fabric.server", "--host", "127.0.0.1", "--port", str(fport)],
        "worker0": worker, "worker1": worker,
        "kv": front + ["--router-mode", "kv", "--router-temperature", "0", "--http-port", str(kport)],
        "rr": front + ["--router-mode", "round_robin", "--http-port", str(rport)],
        "router": [py, "-m", "dynamo_tpu_torch.router", "--block-size", str(BLOCK)],
    }
    for name in ("worker0", "kv", "rr", "router"):
        log("serve_kv: " + " ".join(cmds[name][1:]))
    workers = ["worker0", "worker1"]
    procs, logs, files = {}, {}, []
    out: dict = {"card": card}
    rng = np.random.default_rng(16)
    cases = []  # (mode, group, prompts, request ids)
    for g in range(KV_GROUPS):
        for mode in ("kv", "rr"):
            pfx = [int(t) for t in rng.integers(256 + 26, 128000, size=PREFIX)]
            sfx = [[int(t) for t in rng.integers(256 + 26, 128000, size=int(rng.integers(*KV_SUFFIX)))]
                   for _ in range(1 + KV_FOLLOWERS)]
            cases.append((mode, g, [pfx + s for s in sfx],
                          [f"{mode}-g{g}-{'leader' if k == 0 else f'f{k}'}" for k in range(1 + KV_FOLLOWERS)]))
    streams: dict = {}
    try:
        for name, cmd in cmds.items():
            path = os.path.join(SERVE_DIR, f"kv_{name}.log")
            f = open(path, "w")
            files.append(f)
            logs[name] = LogTail(path)
            penv = dict(env, DYN_KV_HOST_OFFLOAD_GB=KV_HOST_GB) if name in workers else dict(
                env, **KV_HEALTH_ENV)
            procs[name] = subprocess.Popen(cmd, cwd=root, env=penv, stdout=f, stderr=subprocess.STDOUT)
            if name == "fabric":
                time.sleep(1.0)
        t0 = time.perf_counter()
        iid = {w: logs[w].wait_json("worker", 1, procs[w], SERVER_START_S)[0]["instance_id"] for w in workers}
        name_of = {v: k for k, v in iid.items()}
        while True:
            for name, p in procs.items():
                if p.poll() is not None:
                    raise SmokeError(f"{name} exited with {p.returncode} (see {logs[name].path})")
            try:
                ok = all(json.loads(http_call(port, "GET", "/v1/models", timeout=5)[1])["data"]
                         for port in (kport, rport))
                if ok and len(fabric_instances(fport)) == 2:
                    break
            except OSError:
                pass
            if time.perf_counter() - t0 > SERVER_START_S:
                raise SmokeError("the KV deployment did not come up")
            time.sleep(0.5)
        out["start_s"] = time.perf_counter() - t0
        log(f"serve_kv: fabric, 2 workers ({', '.join(f'{w} {iid[w]:x}' for w in workers)}, host tier "
            f"{KV_HOST_GB} GB each), kv + round-robin frontends and the standalone router up in "
            f"{out['start_s']:.1f} s")

        def worker_stats() -> dict:
            seen = {w: len(logs[w].json_lines("worker_stats")) for w in workers}
            for w in workers:
                procs[w].send_signal(signal.SIGUSR1)
            return {w: logs[w].wait_json("worker_stats", seen[w] + 1, procs[w], 30)[-1] for w in workers}

        # warm both workers: their first dispatches at each batch size capture
        # graphs (seconds), which would hold a cold leader's prefill, and so
        # its KV events, past its followers' routing. Round robin puts 4 of
        # 8 concurrent requests on each, then one a worker and one via kv.
        warm = [[int(t) for t in rng.integers(256 + 26, 128000, size=int(n))]
                for n in rng.integers(64, 1100, size=11)]
        with ThreadPoolExecutor(8) as pool:
            warm_out = list(pool.map(lambda k: kv_stream(rport, warm[k], f"warm-{k}"), range(8)))
        for k in range(8, 11):
            warm_out.append(kv_stream(rport if k < 10 else kport, warm[k], f"warm-{k}"))
        base = worker_stats()
        # each warm-up request: the worker that served it, its prompt tokens
        # and its TTFT as the client saw it
        warm_rows = {a["id"]: [w, a["prompt_tokens"]] for w in workers for a in base[w]["admissions"]}
        out["warmup"] = [[f"warm-{k}", *warm_rows.get(f"warm-{k}", ["?", len(warm[k])]),
                          round(o["ttft_ms"], 1)] for k, o in enumerate(warm_out)]
        log(f"serve_kv: the warm-up [request, worker, prompt tokens, TTFT ms]: {out['warmup']}")
        warmed = {w: base[w]["generated_tokens"] for w in workers}
        if not all(warmed.values()):
            raise SmokeError(f"the warm-up missed a worker: {warmed}")
        out["health_after_warmup"] = {m: health_view(p) for m, p in (("kv", kport), ("rr", rport))}
        log(f"serve_kv: the frontends' health planes after the warm-up: {out['health_after_warmup']}")
        # what the workers report to those planes: the phase histograms'
        # counts and medians, and the health series (C15)
        out["worker_series_after_warmup"] = {
            f"{w} {iid[w]:x}": {k: base[w][k] for k in ("phase_counts", "phase_p50_ms", "health_series")}
            for w in workers}
        log(f"serve_kv: the workers' series after the warm-up: {out['worker_series_after_warmup']}")
        # C15: the warm-up's graph captures stay out of the scorer's pace
        # and TTFT, so no fresh worker reads as a gray straggler
        gray = {m: s for m, v in out["health_after_warmup"].items()
                for s in v["scores"].values() if not s < KV_EJECT_RATIO}
        if gray or not all(v["scores"] for v in out["health_after_warmup"].values()):
            raise SmokeError(f"serve_kv: health scores after the warm-up {out['health_after_warmup']}"
                             f"; each must be under the eject ratio {KV_EJECT_RATIO} (C15); the "
                             f"workers' series {out['worker_series_after_warmup']}")
        probes, health = {}, {}
        for mode, g, prompts, rids in cases:
            port = kport if mode == "kv" else rport
            with ThreadPoolExecutor(len(prompts)) as pool:
                t_g = time.perf_counter()
                lead_marks: dict = {}
                futs = [pool.submit(kv_stream, port, prompts[0], rids[0], lead_marks)]
                # the followers share a cached prefix: they go once the
                # leader's first token is back (its prefill done, its Stored
                # events published), KV_GAP_S apart while it decodes
                while not lead_marks.get("n") and not futs[0].done():
                    time.sleep(0.002)
                t_f = time.perf_counter()
                for k in range(1, len(prompts)):
                    time.sleep(max(0.0, t_f + k * KV_GAP_S - time.perf_counter()))
                    health[rids[k]] = health_view(port)
                    futs.append(pool.submit(kv_stream, port, prompts[k], rids[k]))
                if mode == "kv" and g == 0:
                    # the standalone router, asked while the group runs: a new
                    # suffix on the group's prefix, then its free; its index
                    ask = prompts[0][:PREFIX] + prompts[1][PREFIX:PREFIX + 64]
                    found, freed, index = router_calls(fport, [
                        {"token_ids": ask, "request_id": "probe"},
                        {"op": "free", "request_id": "probe"}, {"op": "index"}])
                    probes["during"] = {"find_best": found, "free": freed, "index": index}
                for rid, fut in zip(rids, futs):
                    streams[rid] = fut.result()
            streams[rids[0]]["group_s"] = time.perf_counter() - t_g
        stats = worker_stats()
        # every stream ended: the Removed events must have emptied the index
        t_wait = time.perf_counter()
        while True:
            (index,) = router_calls(fport, [{"op": "index"}])
            if not any(index["index_blocks"].values()) or time.perf_counter() - t_wait > 10:
                break
            time.sleep(0.1)
        probes["after"] = index
        served = {}
        for w in workers:
            for a in stats[w]["admissions"]:
                served.setdefault(a["id"], []).append((w, a["cached_blocks"]))
        rows = {}
        for mode, g, prompts, rids in cases:
            lead = served.get(rids[0])
            if not lead or len(lead) != 1:
                raise SmokeError(f"{rids[0]}: admitted {lead}")
            for rid in rids:
                if len(served.get(rid, [])) != 1:
                    raise SmokeError(f"{rid}: admitted {served.get(rid)} (expected once, on one worker)")
                w, cached = served[rid][0]
                rows[rid] = {"worker": w, "cached_blocks": cached, "ttft_ms": streams[rid]["ttft_ms"],
                             "same_as_leader": w == lead[0][0]}
                if rid in health:  # the frontend's health plane as the follower was sent
                    rows[rid]["health"] = health[rid]
        summary = {}
        for mode in ("kv", "rr"):
            fol = [r for rid, r in rows.items() if rid.startswith(mode) and "leader" not in rid]
            ttft = [r["ttft_ms"] for r in fol]
            summary[mode] = {
                "followers_on_leader_worker": sum(r["same_as_leader"] for r in fol),
                "followers": len(fol),
                "follower_cached_blocks": [r["cached_blocks"] for r in fol],
                "follower_ttft_ms_median": statistics.median(ttft),
                "follower_ttft_ms_max": max(ttft),
                "leader_ttft_ms": [r["ttft_ms"] for rid, r in rows.items()
                                   if rid.startswith(mode) and "leader" in rid],
                "group_s": [streams[rids[0]]["group_s"] for m, _, _, rids in cases if m == mode],
            }
        delta = {w: {k: stats[w][k] - base[w][k] for k in (
            "generated_tokens", "kv_onboarded_blocks", "kv_offloaded_blocks", "kv_offload_errors",
            "kv_onboard_errors")} for w in workers}
        for w in workers:  # the measured traffic's launches, as every counter above
            delta[w]["paged_decode_attention"] = (stats[w]["kernel_launches"]["paged_decode_attention"]
                                                  - base[w]["kernel_launches"]["paged_decode_attention"])
        d = probes["during"]
        out.update(summary=summary, requests=rows, workers=delta, router=probes)
        for mode in ("kv", "rr"):
            s = summary[mode]
            log(f"serve_kv: {mode}: {s['followers_on_leader_worker']}/{s['followers']} followers on their "
                f"leader's worker; follower TTFT median {s['follower_ttft_ms_median']:.1f} ms, max "
                f"{s['follower_ttft_ms_max']:.1f} ms; prefix blocks found in the tier per follower "
                f"{s['follower_cached_blocks']}; leaders' TTFT "
                f"{', '.join(f'{t:.1f}' for t in s['leader_ttft_ms'])} ms ({card})")
        for mode, g, prompts, rids in cases:
            log(f"serve_kv: {mode}-g{g}: " + ", ".join(
                f"{rid.split('-')[-1]} {rows[rid]['worker']} (cached {rows[rid]['cached_blocks']}, "
                f"TTFT {rows[rid]['ttft_ms']:.1f} ms"
                + (f", health scores {rows[rid]['health']['scores']}" if "health" in rows[rid] else "")
                + ")" for rid in rids))
        log("serve_kv: per worker " + "; ".join(
            f"{w}: onboarded {delta[w]['kv_onboarded_blocks']} blocks, offloaded "
            f"{delta[w]['kv_offloaded_blocks']}, #1 launches {delta[w]['paged_decode_attention']}"
            for w in workers))
        log(f"serve_kv: standalone router during kv-g0: find_best -> {name_of[d['find_best']['worker_id']]} "
            f"({d['find_best']['overlap_blocks']} blocks overlap), free ok, index blocks per worker "
            f"{ {name_of[int(k, 16)]: n for k, n in d['index']['index_blocks'].items()} }, "
            f"{d['index']['events']} events applied; after every stream "
            f"{ {name_of[int(k, 16)]: n for k, n in probes['after']['index_blocks'].items()} }")
        print(json.dumps({"serve_kv_routing": out}), flush=True)
        for w in workers:
            integ = stats[w]["integrity"]
            if delta[w]["generated_tokens"] <= 0 or delta[w]["paged_decode_attention"] <= 0:
                raise SmokeError(f"{w} served nothing or launched no #1: {stats[w]}")
            if delta[w]["kv_offload_errors"] or delta[w]["kv_onboard_errors"] or integ["integrity_failures_by_path"]:
                raise SmokeError(f"{w}: tier errors {delta[w]}, integrity {integ}")
        kv = summary["kv"]
        if kv["followers_on_leader_worker"] < KV_FOLLOWERS_ON_LEADER:
            missed = {rid: r for rid, r in rows.items() if rid.startswith("kv") and not r["same_as_leader"]}
            raise SmokeError(f"kv routing put {kv['followers_on_leader_worker']} of {kv['followers']} "
                             f"followers on their leader's worker (at least {KV_FOLLOWERS_ON_LEADER} "
                             f"required); missed: {missed}")
        holder = iid[rows[cases[0][3][0]]["worker"]]  # kv-g0's leader's worker
        if d["find_best"].get("worker_id") != holder or not d["free"].get("ok"):
            raise SmokeError(f"the standalone router's find_best / free while kv-g0 ran: {d} "
                             f"(the leader's worker is {holder:x})")
        if any(probes["after"]["index_blocks"].values()):
            raise SmokeError(f"the router's index still holds blocks after every stream: {probes['after']}")
    finally:
        for name in ("kv", "rr", "router", "worker0", "worker1", "fabric"):
            p = procs.get(name)
            if p is not None and p.poll() is None:
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(30)
        for f in files:
            f.close()
    fronts = {m: logs[m].json_lines("exit_stats") for m in ("kv", "rr")}
    kv_exit = (fronts["kv"] or [{}])[-1].get("kv_routers", {}).get("dyn://dynamo.backend.generate")
    if not kv_exit:
        raise SmokeError(f"the kv frontend printed no router stats: {fronts['kv']}")
    out["kv_frontend_router"] = kv_exit
    if kv_exit["matched_blocks"] <= 0:
        raise SmokeError(f"the kv frontend's router matched no cached block on any decision: {kv_exit}")
    log(f"serve_kv: the kv frontend's router: {kv_exit['decisions']} decisions, "
        f"{kv_exit['matched_blocks']} of {kv_exit['isl_blocks']} prompt blocks on the chosen worker "
        f"(fleet best {kv_exit['fleet_blocks']}), {kv_exit['events']} events, index at exit "
        f"{kv_exit['index_blocks']}")

    # every stream's first tokens against the dense reference, on the
    # workers' weights (seed 0), in this process once the workers are gone
    t_ref = time.perf_counter()
    engine = build_torch_engine(model_dir, device="cuda", max_model_len=MAX_MODEL_LEN, num_blocks=64)
    tok = TokenizerWrapper.from_file(os.path.join(model_dir, "tokenizer.json"))
    ids_of: dict = {}
    for i in range(LLAMA31_8B["vocab_size"]):
        ids_of.setdefault(tok.decode([i], skip_special_tokens=False), []).append(i)
    gaps = []
    try:
        for mode, g, prompts, rids in cases:
            for ids, rid in zip(prompts, rids):
                gaps.append(kv_reference_check(torch, engine.runner, ids, streams[rid]["tokens"], ids_of))
    finally:
        asyncio.run(engine.close())
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    out["reference_max_logit_gap"] = max(gaps)
    log(f"serve_kv: every stream's first {KV_CHECK} tokens agree with the dense reference "
        f"({len(gaps)} streams, largest logit gap {max(gaps):.4f}; {time.perf_counter() - t_ref:.1f} s)")
    out["graph"] = kv_graph_leg(root, env, card)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"serve_kv: phase {out['phase_s']:.1f} s")
    print(json.dumps({"serve_kv": out}), flush=True)
    return out


# ------------------------------------------------------ serve_disagg_fabric
#
# Disaggregation across processes: the port's disagg graph (python -m
# dynamo_tpu_torch.serve dynamo_tpu_torch.graphs.disagg) at Llama-3.1-8B
# width on this card, its services supervised in two groups on the phase's
# own fabric server: two PrefillWorkers and the HTTP frontend, and the
# DecodeWorker (streamed frames, then a second one with DYN_KV_STREAM=0).

# DYN_HBM_GB per worker: three 8B engines (16.1 GB of weights each) share the
# card, each with ~3.1 GB of KV (1464 blocks), leaving room for the prefill
# workers' activations and cached allocations
GRAPH_HBM_GB = "21"
GRAPH_PREFILL_TIMEOUT_S = "45"  # DYN_PREFILL_TIMEOUT_S: past the queue's redelivery
GRAPH_REDELIVER_S = 30.0  # the fabric queue redelivers an unacked request after this long
# the 2000-token TTFT through the graph, per decode mode, and the transport
# alone, streamed and monolithic in turns (cut from 3 and 2 when phase 19
# joined the script, for its time limit)
FABRIC_TTFT_RUNS = 1
TRANSPORT_PAIRS = 1
OVERSIZE_BLOCKS = 256  # 512 MiB of K/V: over the fabric's frame limit once framed
CANCEL_FILLERS = 4  # 3000-token prompts that hold both prefill workers (two in flight each)
GRAPH_ENV_NAME = "llama31-8b"


def http_bodies(pre, tok) -> tuple:
    """serve_http's 8 chat bodies (logprobs on; one with a stop string, one
    with penalties and min_tokens), their contents and their prompt tokens
    after the chat template."""
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest

    overhead = len(pre.preprocess_chat(ChatCompletionRequest.from_dict(chat_body("", 1)))[0].token_ids)
    contents = [prompt_words(tok, max(4, n - overhead), seed=100 + i) for i, n in enumerate(PROMPT_LENS)]
    bodies = []
    for i, (content, m) in enumerate(zip(contents, MAX_TOKENS)):
        extra = {"logprobs": True}
        if i == HTTP_STOP:
            extra["stop"] = ["e"]
        if i == HTTP_PENALIZED:
            extra.update(PENALTIES, min_tokens=MIN_TOKENS)
        bodies.append(chat_body(content, m, **extra))
    expect_prompt = [len(pre.preprocess_chat(ChatCompletionRequest.from_dict(b))[0].token_ids)
                     for b in bodies]
    return contents, bodies, expect_prompt


def body_of_len(pre, tok, lo: int, hi: int, seed: int, max_tokens: int, **extra) -> tuple:
    """A chat body whose templated prompt is lo..hi tokens long, and its ids."""
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest

    n = hi
    for _ in range(64):
        body = chat_body(prompt_words(tok, n, seed=seed), max_tokens, **extra)
        ids = pre.preprocess_chat(ChatCompletionRequest.from_dict(body))[0].token_ids
        if lo <= len(ids) <= hi:
            return body, list(ids)
        n += (hi - len(ids)) // 2 or (1 if len(ids) < lo else -1)
    raise SmokeError(f"no prompt of {lo}..{hi} tokens")


class GraphProc:
    """One supervisor of the disagg graph's services (``python -m
    dynamo_tpu_torch.serve dynamo_tpu_torch.graphs.disagg --only ...``),
    its log holding its children's output: their pids by service, their
    JSON lines and their stats on SIGUSR1."""

    def __init__(self, root: str, env: dict, only: list, path: str, extra: tuple = ()) -> None:
        cmd = [sys.executable, "-m", "dynamo_tpu_torch.serve", "dynamo_tpu_torch.graphs.disagg"]
        for name in only:
            cmd += ["--only", name]
        cmd += list(extra)
        log("serve_disagg_fabric: " + " ".join(cmd[1:]))
        self.path, self.tail = path, LogTail(path)
        self.f = open(path, "w")
        self.proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=self.f,
                                     stderr=subprocess.STDOUT, start_new_session=True)

    def text(self) -> str:
        with open(self.path, errors="replace") as f:
            return f.read()

    def names(self) -> dict:
        """Every pid the supervisor started: {pid: service name}."""
        import re

        return {int(p): n for n, p in re.findall(r"\[([\w-]+)\] started pid (\d+)", self.text())}

    def pid(self, name: str) -> int:
        """The latest pid the supervisor started for ``name`` (e.g.
        PrefillWorker-0)."""
        import re

        got = re.findall(rf"\[{name}\] started pid (\d+)", self.text())
        if not got:
            raise SmokeError(f"{self.path}: {name} was never started")
        return int(got[-1])

    def check(self) -> None:
        if self.proc.poll() is not None:
            raise SmokeError(f"the graph's supervisor exited with {self.proc.returncode} ({self.path})")

    def lines(self, key: str, pid: Optional[int] = None) -> list:
        return [d for d in self.tail.json_lines(key) if pid is None or d.get("pid") == pid]

    def stats(self, pids: list) -> dict:
        """Each pid's ``disagg_stats`` line, printed on SIGUSR1 (one worker
        at a time: they share the log)."""
        import signal

        out = {}
        for p in pids:
            seen = len(self.lines("disagg_stats", p))
            os.kill(p, signal.SIGUSR1)
            t0 = time.perf_counter()
            while len(got := self.lines("disagg_stats", p)) <= seen:
                self.check()
                if time.perf_counter() - t0 > 30:
                    raise SmokeError(f"{self.path}: no stats from pid {p} within 30 s")
                time.sleep(0.02)
            out[p] = got[-1]
        return out

    def stop(self) -> int:
        """SIGTERM the group (the supervisor and its children drain), then
        SIGKILL what is left; the supervisor's exit code."""
        import signal

        for sig, wait in ((signal.SIGTERM, 60), (signal.SIGKILL, 30)):
            try:
                os.killpg(self.proc.pid, sig)
                self.proc.wait(wait)
            except ProcessLookupError:
                break
            except subprocess.TimeoutExpired:
                pass
        self.f.close()
        return self.proc.returncode


def delta(after: dict, before: dict, *path) -> int:
    for k in path:
        after, before = after.get(k, 0), before.get(k, 0)
    return after - before


def graph_replay_launches(stats: dict, kernel: str) -> int:
    """Launches of ``kernel`` a worker made by graph replays."""
    return sum(g["replays"] * g["launches"].get(kernel, 0) for g in stats.get("graphs", {}).values())


def no_integrity_faults(tag: str, stats: dict) -> None:
    i = stats["integrity"]
    if i["integrity_failures_by_path"] or i["fenced_rejects_by_plane"]:
        raise SmokeError(f"{tag}: integrity failures or fenced frames: {i}")


def hang_up(port: int, body: dict, after_s: float) -> None:
    """Send a streamed chat request and close the socket ``after_s`` later."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT_S)
    try:
        conn.request("POST", "/v1/chat/completions", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        time.sleep(after_s)
        conn.sock.shutdown(2)
    finally:
        conn.close()


def to_card(torch, np, arrays) -> None:
    """Host wire arrays (bfloat16 as uint16 words) onto the card, waited for."""
    for a in arrays:
        torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).to("cuda")
    torch.cuda.synchronize()


def transport_turns(torch, np, fport: int, ids: list) -> dict:
    """The transport alone, in turns: this process's RemotePrefillClient
    sends ``ids`` to the graph's prefill workers over the fabric, streamed
    and monolithic, and lands every payload on the card (verify, decode,
    host-to-device); ms from the call to the last block on the card."""
    from dynamo_tpu_torch.disagg.transfer import RemotePrefillClient
    from dynamo_tpu_torch.fabric.client import FabricClient

    async def go():
        fabric = await FabricClient.connect(f"127.0.0.1:{fport}")
        client = RemotePrefillClient(fabric, "dynamo", block_size=BLOCK, timeout=60)
        await client.start()
        rows = {"streamed": [], "monolithic": []}
        frames = {"streamed": [], "monolithic": []}

        async def on_frame(frame):
            to_card(torch, np, frame.payload.decode())
            frames["streamed"][-1] += 1

        try:
            for i in range(TRANSPORT_PAIRS):
                for mode in (("streamed", "monolithic") if i % 2 == 0 else ("monolithic", "streamed")):
                    frames[mode].append(0)
                    t0 = time.perf_counter()
                    resp = await client.prefill(ids, stream=mode == "streamed",
                                                on_frame=on_frame if mode == "streamed" else None)
                    if resp.error is not None or resp.payload is None:
                        raise SmokeError(f"transport {mode}: {resp.error}")
                    to_card(torch, np, resp.payload.decode())
                    rows[mode].append((time.perf_counter() - t0) * 1e3)
        finally:
            await client.close()
            await fabric.close()
        return {"ms": rows, "frames": frames, "wire_bytes_rx": client.stats.bytes_rx}

    return asyncio.run(go())


def fabric_payload_split(torch, np, fport: int, n_blocks: int, reps: int = 1) -> dict:
    """The host path of one monolithic payload of ``n_blocks`` 8B blocks
    through the phase's fabric server, step by step (medians of ``reps``):
    device-to-host (pageable), encode (with its checksums), checksum (a
    verify alone), pack (the port's msgpack), publish (to a subscriber of
    this process: two hops through the server), unpack, decode (with its
    verify) and host-to-device."""
    from dynamo_tpu_torch.disagg.protocols import KvBlockPayload, RemotePrefillResponse, to_wire_array
    from dynamo_tpu_torch.fabric import mpack
    from dynamo_tpu_torch.fabric.client import FabricClient

    shape = (LLAMA31_8B["num_hidden_layers"], 8, n_blocks, BLOCK, 128)
    g = torch.Generator(device="cuda").manual_seed(18)
    k = torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)
    v = torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)
    rows: dict = {n: [] for n in ("d2h", "encode", "checksum", "pack", "publish", "unpack", "decode",
                                  "h2d")}

    async def go():
        fabric = await FabricClient.connect(f"127.0.0.1:{fport}")
        sub = await fabric.subscribe("split.reply")
        try:
            for _ in range(reps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                kh, vh = to_wire_array(k), to_wire_array(v)
                rows["d2h"].append(time.perf_counter() - t)
                t = time.perf_counter()
                payload = KvBlockPayload.encode(kh, vh, "raw", "bfloat16")
                rows["encode"].append(time.perf_counter() - t)
                t = time.perf_counter()
                payload.verify()
                rows["checksum"].append(time.perf_counter() - t)
                t = time.perf_counter()
                data = mpack.packb(RemotePrefillResponse(request_id="split", first_token=0,
                                                         payload=payload).to_wire())
                rows["pack"].append(time.perf_counter() - t)
                t = time.perf_counter()
                await fabric.publish("split.reply", data)
                got = await sub.next(timeout=120)
                rows["publish"].append(time.perf_counter() - t)
                t = time.perf_counter()
                resp = RemotePrefillResponse.from_wire(mpack.unpackb(got[1]))
                rows["unpack"].append(time.perf_counter() - t)
                t = time.perf_counter()
                arrays = resp.payload.decode()
                rows["decode"].append(time.perf_counter() - t)
                t = time.perf_counter()
                to_card(torch, np, arrays)
                rows["h2d"].append(time.perf_counter() - t)
                if not np.array_equal(arrays[0], kh):
                    raise SmokeError("the payload changed on its way through the fabric")
        finally:
            await sub.unsubscribe()
            await fabric.close()
        return len(data)

    nbytes = asyncio.run(go())
    out = {f"{n}_ms": statistics.median(r) * 1e3 for n, r in rows.items()}
    out.update(blocks=n_blocks, wire_bytes=nbytes, kv_bytes=2 * k.numel() * 2)
    return out


def phase_serve_disagg_fabric(torch, np, card: str, http_texts: Optional[list] = None) -> dict:
    """The disagg graph across processes on this card (see the docstring's
    phase 18). ``http_texts``: serve_http's 8 texts, when it ran."""
    import re
    import signal
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.tokenizer import TokenizerWrapper

    t_phase = time.perf_counter()
    L = LLAMA31_8B["num_hidden_layers"]
    model_dir = write_serve_dir()
    mdc = ModelDeploymentCard.from_model_dir(model_dir, GRAPH_ENV_NAME, context_length=MAX_MODEL_LEN)
    pre = OpenAIPreprocessor(mdc)
    tok = pre.tokenizer
    _, bodies, expect_prompt = http_bodies(pre, tok)
    prompt_ids = [list(pre.preprocess_chat(ChatCompletionRequest.from_dict(b))[0].token_ids)
                  for b in bodies]
    shipped = [i for i, n in enumerate(expect_prompt) if n > DISAGG_LOCAL_MAX]
    one_shot = [i for i in shipped if expect_prompt[i] <= 512]  # prefill_only_stream's
    long_body, long_ids = body_of_len(pre, tok, 1990, 2000, 31, 2)
    redeliver_body, redeliver_ids = body_of_len(pre, tok, 1990, 2000, 32, 16, logprobs=True,
                                                nvext={"ignore_eos": True})
    over_hi = OVERSIZE_BLOCKS * BLOCK - 8
    oversize_body, oversize_ids = body_of_len(pre, tok, over_hi - BLOCK + 9, over_hi, 33, 8,
                                              nvext={"ignore_eos": True})
    n_long = -(-len(long_ids) // BLOCK)

    root = os.path.dirname(os.path.abspath(__file__))
    fport, hport = free_port(), free_port()
    genv = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
                DYN_FABRIC_ADDR=f"127.0.0.1:{fport}", DYN_GRAPH_ENGINE="torch",
                DYN_MODEL_PATH=model_dir, DYN_MODEL_NAME=GRAPH_ENV_NAME, DYN_HBM_GB=GRAPH_HBM_GB,
                DYN_MAX_LOCAL_PREFILL=str(DISAGG_LOCAL_MAX),
                DYN_PREFILL_TIMEOUT_S=GRAPH_PREFILL_TIMEOUT_S,
                DYN_HTTP_HOST="127.0.0.1", DYN_HTTP_PORT=str(hport))
    genv.pop("DYN_KV_STREAM", None)
    out: dict = {"card": card, "shipped": len(shipped), "one_shot": len(one_shot),
                 "hbm_gb_per_worker": float(GRAPH_HBM_GB)}
    fab_log = open(os.path.join(SERVE_DIR, "disagg_fabric.log"), "w")
    fabric = subprocess.Popen([sys.executable, "-m", "dynamo_tpu_torch.fabric.server", "--host",
                               "127.0.0.1", "--port", str(fport)], cwd=root, env=genv,
                              stdout=fab_log, stderr=subprocess.STDOUT)
    time.sleep(1.0)
    graphs: list = []
    texts: dict = {}
    try:
        pre_graph = GraphProc(root, genv, ["PrefillWorker", "Frontend"],
                              os.path.join(SERVE_DIR, "disagg_prefill.log"),
                              ("--replicas", "PrefillWorker=2"))
        graphs.append(pre_graph)

        def prefill_pids() -> list:
            return [pre_graph.pid(f"PrefillWorker-{r}") for r in range(2)]

        def start_decode(stream: bool) -> GraphProc:
            env = dict(genv) if stream else dict(genv, DYN_KV_STREAM="0")
            g = GraphProc(root, env, ["DecodeWorker"],
                          os.path.join(SERVE_DIR, f"disagg_decode_{'stream' if stream else 'mono'}.log"))
            graphs.append(g)
            t0 = time.perf_counter()
            while True:
                for p in (pre_graph, g):
                    p.check()
                if fabric.poll() is not None:
                    raise SmokeError(f"the fabric server exited with {fabric.returncode}")
                try:
                    up = (len(pre_graph.lines("prefill_worker")) >= 2 and g.tail.json_lines("worker")
                          and json.loads(http_call(hport, "GET", "/v1/models", timeout=5)[1])["data"])
                except (OSError, ValueError):
                    up = False
                if up:
                    return g, time.perf_counter() - t0
                if time.perf_counter() - t0 > SERVER_START_S:
                    raise SmokeError("the disagg graph did not come up")
                time.sleep(0.25)

        def all_stats(decode: GraphProc) -> tuple:
            dp = decode.pid("DecodeWorker-0")
            pp = prefill_pids()
            return dp, pp, {**pre_graph.stats(pp), **decode.stats([dp])}

        def traffic(tag: str, decode: GraphProc, stream: bool) -> dict:
            """serve_http's 8 requests at once through the frontend, checked
            against the workers' counters read just before and just after."""
            dp, pp, before = all_stats(decode)
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(bodies)) as pool:
                results = list(pool.map(lambda b: stream_tokens(hport, b, {}), bodies))
            wall = time.perf_counter() - t0
            _, _, after = all_stats(decode)
            for i, (r, b) in enumerate(zip(results, bodies)):
                u = r["usage"]
                if u["prompt_tokens"] != expect_prompt[i] or u["completion_tokens"] != len(r["tokens"]) or (
                        not 0 < len(r["tokens"]) <= b["max_tokens"]):
                    raise SmokeError(f"{tag} stream {i}: usage {u}, {len(r['tokens'])} tokens")
            d, a = after[dp], before[dp]
            row = {"wall_s": wall, "tokens": sum(len(r["tokens"]) for r in results),
                   "remote_prefills": delta(d, a, "remote_prefills"),
                   "remote_fallbacks": delta(d, a, "remote_fallbacks"),
                   "decode_launches": delta(d, a, "kernel_launches", "paged_decode_attention"),
                   "decode_replay_launches": (graph_replay_launches(d, "paged_decode_attention")
                                              - graph_replay_launches(a, "paged_decode_attention")),
                   "prefill_launches": sum(delta(after[p], before[p], "kernel_launches",
                                                 "flash_prefill_attention") for p in pp),
                   "frames_rx": delta(d, a, "transfer", "frames_rx"),
                   "bytes_rx": delta(d, a, "transfer", "bytes_rx"),
                   "frames_tx": sum(delta(after[p], before[p], "transfer", "frames_tx") for p in pp),
                   "bytes_tx": sum(delta(after[p], before[p], "transfer", "bytes_tx") for p in pp),
                   "served_per_worker": [delta(after[p], before[p], "prefills_served") for p in pp]}
            want3 = L * len(shipped if not stream else one_shot)
            if row["remote_prefills"] != len(shipped) or row["remote_fallbacks"]:
                raise SmokeError(f"{tag}: {row['remote_prefills']} remote prefills, "
                                 f"{row['remote_fallbacks']} fallbacks; {len(shipped)} prompts ship")
            if not 0 < row["decode_launches"] == row["decode_replay_launches"]:
                raise SmokeError(f"{tag}: the decode worker's #1 launches {row['decode_launches']}, "
                                 f"by replays {row['decode_replay_launches']}")
            if row["prefill_launches"] != want3:
                raise SmokeError(f"{tag}: the prefill workers launched #3 {row['prefill_launches']} "
                                 f"times, expected {want3}")
            if (row["frames_rx"], row["bytes_rx"]) != (row["frames_tx"], row["bytes_tx"]) or (
                    (row["frames_rx"] > 0) != stream or row["bytes_rx"] <= 0):
                raise SmokeError(f"{tag}: frames / bytes received {row['frames_rx']} / "
                                 f"{row['bytes_rx']}, sent {row['frames_tx']} / {row['bytes_tx']}")
            for p in [dp, *pp]:
                no_integrity_faults(f"{tag} pid {p}", after[p])
            texts[tag] = results
            same = [http_texts is not None and r["text"] == http_texts[i] for i, r in enumerate(results)]
            row["texts_equal_serve_http"] = sum(same)
            log(f"serve_disagg_fabric/{tag}: serve_http's 8 requests in {wall:.2f} s "
                f"({row['tokens']} tokens); {row['remote_prefills']} remote prefills, "
                f"{row['remote_fallbacks']} fallbacks; #3 on the prefill workers {row['prefill_launches']} "
                f"(= {L} x {want3 // L}), prefills served per worker {row['served_per_worker']}; #1 on the "
                f"decode worker {row['decode_launches']}, all by replays; frames {row['frames_rx']}, "
                f"wire bytes {row['bytes_rx']} (= sent); texts equal to serve_http's "
                f"{row['texts_equal_serve_http']} of 8 ({card})")
            return row

        def ttfts() -> list:
            return [stream_chat(hport, long_body)["ttft_s"] * 1e3 for _ in range(FABRIC_TTFT_RUNS)]

        # (a) streamed frames
        decode, out["start_s"] = start_decode(True)
        log(f"serve_disagg_fabric: fabric, 2 PrefillWorkers, the DecodeWorker and the frontend up in "
            f"{out['start_s']:.1f} s (DYN_HBM_GB {GRAPH_HBM_GB} each)")
        out["streamed"] = traffic("streamed", decode, True)
        out["ttft_2000_streamed_ms"] = ttfts()
        out["transport"] = transport_turns(torch, np, fport, long_ids)
        out["host_split"] = fabric_payload_split(torch, np, fport, n_long)
        gc.collect()
        torch.cuda.empty_cache()  # the payloads this process landed: the card is the workers'

        # a decode-side cancel: four long prompts hold both prefill workers,
        # a fifth is hung up on while it waits or streams
        dp, pp, before = all_stats(decode)
        fillers = [body_of_len(pre, tok, 2900, 3000, 40 + i, 4)[0] for i in range(CANCEL_FILLERS)]
        victim = body_of_len(pre, tok, 1990, 2000, 45, 4)[0]
        with ThreadPoolExecutor(CANCEL_FILLERS) as pool:
            futs = [pool.submit(stream_chat, hport, b) for b in fillers]
            time.sleep(0.2)
            hang_up(hport, victim, 0.3)
            for f in futs:
                f.result()
        t0 = time.perf_counter()
        while True:
            _, _, after = all_stats(decode)
            d = after[dp]
            cancelled = sum(delta(after[p], before[p], "transfer", "streams_cancelled") for p in pp)
            if not d["busy_lanes"] and d["free_blocks"] == d["num_blocks"] - 1 and cancelled:
                break
            if time.perf_counter() - t0 > 30:
                raise SmokeError(f"cancel: the decode worker holds {d['busy_lanes']} lanes, "
                                 f"{d['num_blocks'] - 1 - d['free_blocks']} blocks; prefill workers "
                                 f"cancelled {cancelled} streams")
            time.sleep(0.5)
        out["cancel"] = {"prefill_streams_cancelled": cancelled,
                         "decode_streams_cancelled": delta(d, before[dp], "transfer", "streams_cancelled"),
                         "decode_free_blocks": d["free_blocks"], "num_blocks": d["num_blocks"]}
        log(f"serve_disagg_fabric: a hung-up request: the prefill workers cancelled {cancelled} stream(s), "
            f"the decode worker's client {out['cancel']['decode_streams_cancelled']}; the decode worker "
            f"holds no lane and every block is free ({d['free_blocks']} of {d['num_blocks']} - 1)")
        if decode.stop() != 0:
            raise SmokeError("the streamed DecodeWorker's supervisor did not exit 0")

        # (b) monolithic payloads (DYN_KV_STREAM=0 on a new decode worker)
        decode, out["mono_start_s"] = start_decode(False)
        out["monolithic"] = traffic("monolithic", decode, False)
        out["ttft_2000_monolithic_ms"] = ttfts()

        # a 256-block payload, over the fabric's frame limit
        dp, pp, before = all_stats(decode)
        t0 = time.perf_counter()
        r = stream_chat(hport, oversize_body)
        over_s = time.perf_counter() - t0
        _, _, after = all_stats(decode)
        too_large = sum(delta(after[p], before[p], "transfer", "too_large") for p in pp)
        fell = delta(after[dp], before[dp], "remote_fallbacks")
        if r["usage"]["completion_tokens"] != 8 or too_large != 1 or fell != 1 or (
                over_s > float(GRAPH_PREFILL_TIMEOUT_S)):
            raise SmokeError(f"oversize: {r['usage']}, too_large {too_large}, fallbacks {fell}, "
                             f"{over_s:.1f} s")
        out["oversize"] = {"prompt_tokens": len(oversize_ids), "blocks": -(-len(oversize_ids) // BLOCK),
                           "too_large": too_large, "fallbacks": fell, "request_s": over_s}
        log(f"serve_disagg_fabric: a {len(oversize_ids)}-token prompt ({out['oversize']['blocks']} blocks, "
            f"over the fabric's 512 MiB frame): the prefill worker answered too_large, the decode "
            f"worker prefilled locally at once; {over_s:.2f} s for 8 tokens")

        # redelivery: SIGKILL the prefill worker holding a 2000-token prompt
        dp, pp, before = all_stats(decode)
        mark = len(pre_graph.text())
        took = re.compile(r"prefill worker pid (\d+) took (\w+): (\d+) tokens")
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(stream_tokens, hport, redeliver_body, {})
            t0 = time.perf_counter()
            while True:
                hit = [m for m in took.finditer(pre_graph.text()[mark:])
                       if int(m.group(3)) == len(redeliver_ids)]
                if hit:
                    break
                if fut.done() or time.perf_counter() - t0 > 60:
                    raise SmokeError("redelivery: no prefill worker took the 2000-token prompt")
                time.sleep(0.005)
            victim_pid, rid = int(hit[0].group(1)), hit[0].group(2)
            t_kill = time.perf_counter()
            os.kill(victim_pid, signal.SIGKILL)
            names = pre_graph.names()
            got = fut.result(timeout=GRAPH_REDELIVER_S + 90)
            end_s = time.perf_counter() - t_kill
        if len(got["tokens"]) != 16 or got["finish"] != ["length"]:
            raise SmokeError(f"redelivery: the stream ended with {len(got['tokens'])} tokens, {got['finish']}")
        again = [int(m.group(1)) for m in took.finditer(pre_graph.text()[mark:]) if m.group(2) == rid][1:]
        _, _, after = all_stats(decode)
        fell = delta(after[dp], before[dp], "remote_fallbacks")
        out["redelivery"] = {"killed": names.get(victim_pid, str(victim_pid)), "redelivered_to": again,
                             "decode_fell_back": bool(fell), "kill_to_stream_end_s": end_s}
        log(f"serve_disagg_fabric: SIGKILL of {out['redelivery']['killed']} (pid {victim_pid}) holding "
            f"the 2000-token prompt: the queue redelivered it to pid(s) {again}; the decode worker "
            f"{'fell back to a local prefill' if fell else 'landed the redelivered prefill'}; the stream "
            f"completed ({len(got['tokens'])} tokens) {end_s:.1f} s after the kill")
        texts["redelivery"] = [got]
        if decode.stop() != 0:
            raise SmokeError("the monolithic DecodeWorker's supervisor did not exit 0")
        exit_d = decode.lines("disagg_exit_stats")
        if not exit_d or exit_d[-1]["busy_lanes"] or exit_d[-1]["free_blocks"] != exit_d[-1]["num_blocks"] - 1:
            raise SmokeError(f"the decode worker's exit stats: {exit_d[-1:]}")
    finally:
        for g in reversed(graphs):
            if g.proc.poll() is None:
                g.stop()
        fabric.send_signal(signal.SIGTERM)
        try:
            fabric.wait(30)
        except subprocess.TimeoutExpired:
            fabric.kill()
            fabric.wait(30)
        fab_log.close()

    # streams whose text differs from serve_http's: the dense reference on
    # their first tokens, over the workers' weights, once the graph is gone
    check = [(tag, i) for tag in ("streamed", "monolithic") for i, r in enumerate(texts[tag])
             if i != HTTP_PENALIZED and (http_texts is None or r["text"] != http_texts[i])]
    check.append(("redelivery", 0))
    gaps = []
    engine = build_torch_engine(model_dir, device="cuda", max_model_len=MAX_MODEL_LEN, num_blocks=64)
    try:
        rtok = TokenizerWrapper.from_file(os.path.join(model_dir, "tokenizer.json"))
        ids_of: dict = {}
        for i in range(LLAMA31_8B["vocab_size"]):
            ids_of.setdefault(rtok.decode([i], skip_special_tokens=False), []).append(i)
        for tag, i in check:
            prompt = redeliver_ids if tag == "redelivery" else prompt_ids[i]
            pieces = texts[tag][i]["tokens"]
            gaps.append(kv_reference_check(torch, engine.runner, prompt, pieces, ids_of,
                                           n_check=min(KV_CHECK, len(pieces))))
    finally:
        asyncio.run(engine.close())
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    out["reference"] = {"streams_checked": [f"{t}/{i}" for t, i in check], "max_logit_gap": max(gaps)}
    s, m, tr, hs = out["streamed"], out["monolithic"], out["transport"], out["host_split"]
    log(f"serve_disagg_fabric: dense reference on {len(check)} streams (those whose text differs from "
        f"serve_http's, and the redelivered one): largest logit gap {max(gaps):.4f} (bound 0.25)")
    log(f"serve_disagg_fabric: 2000-token TTFT through the graph, streamed {statistics.median(out['ttft_2000_streamed_ms']):.1f} ms "
        f"(runs {[round(x, 1) for x in out['ttft_2000_streamed_ms']]}), monolithic "
        f"{statistics.median(out['ttft_2000_monolithic_ms']):.1f} ms "
        f"({[round(x, 1) for x in out['ttft_2000_monolithic_ms']]}); the transport alone in turns "
        f"(this process's client, landing on the card): streamed "
        f"{statistics.median(tr['ms']['streamed']):.1f} ms, monolithic "
        f"{statistics.median(tr['ms']['monolithic']):.1f} ms; host path of {hs['blocks']} blocks "
        f"({hs['kv_bytes'] / 1e6:.1f} MB of K/V, {hs['wire_bytes']} wire bytes): d2h {hs['d2h_ms']:.1f} / "
        f"encode {hs['encode_ms']:.1f} / checksum {hs['checksum_ms']:.1f} / pack {hs['pack_ms']:.1f} / "
        f"publish {hs['publish_ms']:.1f} / unpack {hs['unpack_ms']:.1f} / decode {hs['decode_ms']:.1f} / "
        f"h2d {hs['h2d_ms']:.1f} ms; traffic {s['wall_s']:.2f} s streamed, {m['wall_s']:.2f} s monolithic ({card})")
    out["launches"] = {"flash_prefill_attention": s["prefill_launches"] + m["prefill_launches"],
                       "paged_decode_attention": s["decode_launches"] + m["decode_launches"]}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"serve_disagg_fabric: phase {out['phase_s']:.1f} s")
    print(json.dumps({"serve_disagg_fabric": {k: v for k, v in out.items()}}), flush=True)
    return out


# ------------------------------------------------------- serve_trace_faults
#
# Request tracing and fault injection: a traced fleet (fabric, a KV frontend,
# two workers, every process with DYN_TRACE=1), one worker restarted under
# DYN_FAULT=kill_after_tokens, a traced disagg graph whose prefill worker
# corrupts its KV payloads, then in this process slow_decode,
# abort_after_tokens and tracing on against off on the graphed engine.

TF_KILL_AFTER = 40  # DYN_FAULT=kill_after_tokens on the restarted worker
TF_MIGRATE_TOKENS = 128
TF_MIGRATE_STREAMS = 4  # at once: the KV router spreads them over both workers
MIGRATED = r"request (tfm-\d+): worker \w+ failed mid-stream .* replaying (\d+) emitted"
TF_CORRUPT = "corrupt_kv=bits,every=2"
# serve_http's 800- and 1600-token prompts (not its 1200-token one, whose
# penalties the dense reference does not apply)
TF_DISAGG_LONG = (4, 6)
TF_SLOW = 3.0  # slow_decode's factor
TF_ABORT_AFTER = 50
TF_TURNS = 1  # tracing on / off, in turns
TF_SPANS = ("http_request", "route", "worker_generate", "queue_wait", "decode")


def traceparent(tag: str, i: int) -> tuple:
    """A W3C traceparent whose trace id is the run's tag and the request's
    index (and the id): each run's requests get traces of their own."""
    import zlib

    tid = f"{zlib.crc32(tag.encode()):08x}{i + 1:024x}"
    return f"00-{tid}-{i + 1:016x}-01", tid


def trace_slices(port: int, rid: str) -> tuple:
    """``GET /debug/traces/{rid}``: (document, {name: [span slices in start
    order]}, {span id: slice})."""
    st, data = http_call(port, "GET", f"/debug/traces/{rid}")
    if st != 200:
        raise SmokeError(f"/debug/traces/{rid} answered {st}: {data[:300]!r}")
    doc = json.loads(data)
    xs = sorted((e for e in doc["traceEvents"] if e["ph"] == "X"), key=lambda e: e["ts"])
    by_name: dict = {}
    for e in xs:
        by_name.setdefault(e["name"], []).append(e)
    return doc, by_name, {e["args"]["span_id"]: e for e in xs}


def check_trace(tag: str, doc: dict, by_name: dict, by_id: dict, tid: str, parent: str,
                names, min_tracks: int) -> int:
    """One trace id, every parent inside the trace (the root's is the
    inbound traceparent's span), the span names asked for, and at least
    ``min_tracks`` process tracks; returns the number of tracks."""
    if doc["otherData"]["trace_id"] != tid or doc["otherData"].get("partial"):
        raise SmokeError(f"{tag}: trace {doc['otherData']}")
    for sid, e in by_id.items():
        want = parent if e["name"] == "http_request" else None
        if (want is not None and e["args"]["parent_id"] != want) or (
                want is None and e["args"]["parent_id"] not in by_id):
            raise SmokeError(f"{tag}: span {e['name']} {sid} has its parent "
                             f"{e['args']['parent_id']} outside the trace")
    missing = [n for n in names if n not in by_name]
    tracks = {e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    if missing or len(tracks) < min_tracks:
        raise SmokeError(f"{tag}: spans {sorted(by_name)} lack {missing}, or tracks {tracks}")
    return len(tracks)


def ttft_hops(by_name: dict, first_wall_s: float, prefill: str = "prefill") -> dict:
    """A request's TTFT split by hop from its spans (ms): edge to the route
    decision's end, to the worker's span, its queue wait, its prefill (the
    admission to the first token), and the first frame back to the client."""
    def end(e):
        return e["ts"] + e["dur"]

    root, pf = by_name["http_request"][0], by_name[prefill][0]
    wg, qw = by_name["worker_generate"][0], by_name["queue_wait"][0]
    # without a kv router (no route span) the edge hands straight on
    routed = end(by_name["route"][0]) if "route" in by_name else root["ts"]
    return {"edge_to_route": (routed - root["ts"]) / 1e3,
            "route_to_worker": (wg["ts"] - routed) / 1e3,
            "queue_wait": qw["dur"] / 1e3, "prefill": pf["dur"] / 1e3,
            "first_frame_back": (first_wall_s * 1e6 - end(pf)) / 1e3,
            "ttft": (first_wall_s * 1e6 - root["ts"]) / 1e3}


def start_procs(cmds: dict, env: dict, root: str, prefix: str, procs: dict, logs: dict,
                files: list) -> None:
    for name, cmd in cmds.items():
        path = os.path.join(SERVE_DIR, f"{prefix}_{name}.log")
        f = open(path, "w")
        files.append(f)
        logs[name] = LogTail(path)
        procs[name] = subprocess.Popen(cmd, cwd=root, env=env.get(name, env["*"]), stdout=f,
                                       stderr=subprocess.STDOUT)
        if name == "fabric":
            time.sleep(1.0)


def wait_fleet(procs: dict, logs: dict, workers: list, hport: int, fport: int) -> float:
    t0 = time.perf_counter()
    for w in workers:
        logs[w].wait_json("worker", 1, procs[w], SERVER_START_S)
    while True:
        for name, p in procs.items():
            if p.poll() is not None and name in workers + ["fabric", "frontend"]:
                raise SmokeError(f"{name} exited with {p.returncode} (see {logs[name].path})")
        try:
            st, data = http_call(hport, "GET", "/v1/models", timeout=5)
            if st == 200 and json.loads(data)["data"] and len(fabric_instances(fport)) == len(workers):
                return time.perf_counter() - t0
        except OSError:
            pass
        if time.perf_counter() - t0 > SERVER_START_S:
            raise SmokeError("the traced fleet did not come up")
        time.sleep(0.25)


def stop_procs(procs: dict, order) -> None:
    import signal

    for name in order:
        p = procs.get(name)
        if p is not None and p.poll() is None:
            p.send_signal(signal.SIGTERM)
            try:
                p.wait(60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(30)


def traced_streams(hport: int, bodies: list, tag: str) -> list:
    """``bodies`` streamed at once, each with its traceparent and request
    id; (result, request id, trace id, parent span id, first token wall s)
    per body."""
    from concurrent.futures import ThreadPoolExecutor

    offset = time.time() - time.perf_counter()

    def one(i_body):
        i, body = i_body
        tp, tid = traceparent(tag, i)
        rid = f"{tag}-{i}"
        r = stream_tokens(hport, dict(body, stream_options={"include_usage": True}), {},
                          headers={"traceparent": tp, "x-request-id": rid})
        if not r["times"] or not (r["usage"] or {}).get("timing"):
            raise SmokeError(f"{tag} {i}: no tokens or no usage.timing: {r['usage']}")
        return r, rid, tid, tp.split("-")[2], r["times"][0] + offset

    with ThreadPoolExecutor(len(bodies)) as pool:
        return list(pool.map(one, enumerate(bodies)))


def median_hops(rows: list) -> dict:
    return {k: statistics.median(r[k] for r in rows) for k in rows[0]}


# serve_trace_faults' model: Llama-3.1-8B's width at 8 of its 32 layers
# (FLEET_MODEL's 16 until the multimodal slice cut it to make room for its
# own legs; every check reads the depth from the model directory)
TF_MODEL = dict(LLAMA31_8B, num_hidden_layers=8)


def phase_serve_trace_faults(torch, np, card: str) -> dict:
    """Tracing and fault injection across processes and in this one (see
    the module docstring, phase 19)."""
    import re
    import signal
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.protocols.common import (
        Context, FinishReason, PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.telemetry import trace as dtrace
    from dynamo_tpu_torch.testing import faults
    from dynamo_tpu_torch.tokenizer import TokenizerWrapper

    t_phase = time.perf_counter()
    model_dir = write_serve_dir(TF_MODEL)
    mdc = ModelDeploymentCard.from_model_dir(model_dir, GRAPH_ENV_NAME, context_length=MAX_MODEL_LEN)
    pre = OpenAIPreprocessor(mdc)
    tok = pre.tokenizer

    def ids_of_body(body) -> list:
        return list(pre.preprocess_chat(ChatCompletionRequest.from_dict(body))[0].token_ids)

    _, bodies, _ = http_bodies(pre, tok)
    mig_bodies = [chat_body(prompt_words(tok, 300, seed=60 + i), TF_MIGRATE_TOKENS, logprobs=True,
                            nvext={"ignore_eos": True}) for i in range(TF_MIGRATE_STREAMS)]
    long_body, long_ids = body_of_len(pre, tok, 1990, 2000, 31, 8, logprobs=True)
    disagg_bodies = [long_body] + [dict(bodies[i], max_tokens=8) for i in TF_DISAGG_LONG]
    root = os.path.dirname(os.path.abspath(__file__))
    py = sys.executable
    base_env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
                    DYN_TRACE="1", DYN_LEASE_TTL_S=str(FABRIC_TTL_S))
    for k in ("DYN_FAULT", "DYN_KV_STREAM", "DYN_TRACE_DIR"):
        base_env.pop(k, None)
    out: dict = {"card": card}
    checks: list = []  # (tag, prompt ids, token strings, tokens checked) for the dense reference

    # (a) the traced fleet, then (c) a worker restarted under kill_after_tokens
    fport, hport = free_port(), free_port()
    env = dict(base_env, DYN_FABRIC_ADDR=f"127.0.0.1:{fport}")

    def worker_cmd() -> list:
        return [py, "-m", "dynamo_tpu_torch.run", "in=dyn://dynamo.backend.generate", "out=torch",
                "--model-path", model_dir, "--model-name", GRAPH_ENV_NAME,
                "--context-length", str(MAX_MODEL_LEN), "--num-blocks", str(FABRIC_BLOCKS)]

    cmds = {
        "fabric": [py, "-m", "dynamo_tpu_torch.fabric.server", "--host", "127.0.0.1", "--port", str(fport)],
        "worker0": worker_cmd(), "worker1": worker_cmd(),
        "frontend": [py, "-m", "dynamo_tpu_torch.run", "in=http", "out=dyn", "--router-mode", "kv",
                     "--http-host", "127.0.0.1", "--http-port", str(hport)],
    }
    procs, logs, files = {}, {}, []
    try:
        start_procs(cmds, {"*": env}, root, "tf", procs, logs, files)
        out["fleet_start_s"] = wait_fleet(procs, logs, ["worker0", "worker1"], hport, fport)
        log(f"serve_trace_faults: fabric, a kv frontend and 2 workers, DYN_TRACE=1 in each, up in "
            f"{out['fleet_start_s']:.1f} s")
        # a first pass of the same traffic captures the workers' graphs and
        # compiles their shapes; the second is the one read
        stream_chat(hport, chat_body("hello there", 4))
        traced_streams(hport, bodies, "tf-warm")
        got = traced_streams(hport, bodies, "tf")
        hops, tracks = [], []
        for i, (r, rid, tid, parent, first) in enumerate(got):
            doc, by_name, by_id = trace_slices(hport, rid)
            tracks.append(check_trace(f"traced fleet {i}", doc, by_name, by_id, tid, parent,
                                      TF_SPANS, 2))
            hops.append(ttft_hops(by_name, first))
        out["fleet"] = {"traces": len(got), "tracks": tracks, "hops_ms": hops,
                        "hops_median_ms": median_hops(hops)}
        for i, h in enumerate(hops):
            log(f"serve_trace_faults/fleet: request {i} ({PROMPT_LENS[i]} tokens): "
                + ", ".join(f"{k} {v:.2f}" for k, v in h.items()) + " ms")
        m = out["fleet"]["hops_median_ms"]
        log(f"serve_trace_faults/fleet: {len(got)} of {len(bodies)} traces assembled by "
            f"/debug/traces, each one trace id over {min(tracks)}-{max(tracks)} process tracks, every "
            f"parent inside it, spans {', '.join(TF_SPANS)} present, usage.timing on every final chunk")
        log(f"serve_trace_faults/fleet: TTFT by hop, medians of 8 (ms): edge -> route "
            f"{m['edge_to_route']:.2f}, route -> worker {m['route_to_worker']:.2f}, queue_wait "
            f"{m['queue_wait']:.2f}, prefill {m['prefill']:.2f}, first frame back "
            f"{m['first_frame_back']:.2f}; TTFT {m['ttft']:.2f} ({card})")

        # (c) worker1 drained, then started again under kill_after_tokens
        procs["worker1"].send_signal(signal.SIGTERM)
        if procs["worker1"].wait(120) != 0:
            raise SmokeError("the traced worker1 did not drain to exit 0")
        killer = dict(env, DYN_FAULT=f"kill_after_tokens={TF_KILL_AFTER}")
        start_procs({"worker1f": worker_cmd()}, {"*": killer}, root, "tf", procs, logs, files)
        out["fault_worker_start_s"] = wait_fleet(procs, logs, ["worker0", "worker1f"], hport, fport)
        with ThreadPoolExecutor(len(mig_bodies)) as pool:
            mig = list(pool.map(lambda ib: stream_tokens(hport, ib[1], {}, headers={
                "x-request-id": f"tfm-{ib[0]}"}), enumerate(mig_bodies)))
        rc = procs["worker1f"].wait(60)
        if rc != -signal.SIGKILL:
            raise SmokeError(f"the faulted worker exited with {rc}, not by its SIGKILL")
        stop_procs(procs, ("frontend",))
        # where each migrated stream was cut: its tokens from there on came
        # from the replay on the survivor
        with open(logs["frontend"].path) as f:
            cuts = {rid: int(n) for rid, n in re.findall(MIGRATED, f.read())}
        for i, r in enumerate(mig):
            if len(r["tokens"]) != TF_MIGRATE_TOKENS or r["finish"] != ["length"] or (
                    r["usage"]["completion_tokens"] != TF_MIGRATE_TOKENS):
                raise SmokeError(f"migrating stream {i}: {len(r['tokens'])} tokens, {r['finish']}, "
                                 f"{r['usage']}")
            # a migrated stream: the first tokens of its replay; else its first
            cut = cuts.get(f"tfm-{i}", 0)
            checks.append((f"migrate/{i}", ids_of_body(mig_bodies[i]), r["tokens"],
                           (cut, cut + KV_CHECK)))
        front = logs["frontend"].json_lines("exit_stats")
        n_mig = sum(front[-1]["migrations"].values()) if front else 0
        if n_mig < 1:
            raise SmokeError(f"the frontend counted no migration: {front}")
        if not cuts:
            raise SmokeError("the frontend logged no migrated stream")
        out["kill"] = {"kill_after_tokens": TF_KILL_AFTER, "streams": len(mig), "migrations": n_mig,
                       "cuts": cuts, "worker_exit": rc, "restart_s": out["fault_worker_start_s"]}
        log(f"serve_trace_faults/kill: worker1 restarted under DYN_FAULT=kill_after_tokens="
            f"{TF_KILL_AFTER} (up in {out['fault_worker_start_s']:.1f} s) SIGKILLed itself; "
            f"{len(mig)} streams of {TF_MIGRATE_TOKENS} tokens at once all complete, no error frame, "
            f"no token lost; the frontend counted {n_mig} migration(s) (streams cut after {cuts} "
            f"tokens)")
    finally:
        stop_procs(procs, ("frontend", "worker0", "worker1", "worker1f", "fabric"))
        for f in files:
            f.close()

    # (b) the traced disagg graph, its prefill worker corrupting payloads
    fport, hport = free_port(), free_port()
    # the graph's services take their lease before they build their engines
    # (a build blocks the loop): the default TTL, as serve_disagg_fabric
    genv = dict(base_env, DYN_FABRIC_ADDR=f"127.0.0.1:{fport}", DYN_GRAPH_ENGINE="torch",
                DYN_MODEL_PATH=model_dir, DYN_MODEL_NAME=GRAPH_ENV_NAME, DYN_HBM_GB=GRAPH_HBM_GB,
                DYN_MAX_LOCAL_PREFILL=str(DISAGG_LOCAL_MAX),
                DYN_PREFILL_TIMEOUT_S=GRAPH_PREFILL_TIMEOUT_S,
                DYN_HTTP_HOST="127.0.0.1", DYN_HTTP_PORT=str(hport))
    genv.pop("DYN_LEASE_TTL_S")
    fab_log = open(os.path.join(SERVE_DIR, "tf_disagg_fabric.log"), "w")
    fabric = subprocess.Popen([py, "-m", "dynamo_tpu_torch.fabric.server", "--host", "127.0.0.1",
                               "--port", str(fport)], cwd=root, env=genv, stdout=fab_log,
                              stderr=subprocess.STDOUT)
    time.sleep(1.0)
    graphs: list = []
    try:
        pre_graph = GraphProc(root, dict(genv, DYN_FAULT=TF_CORRUPT), ["PrefillWorker", "Frontend"],
                              os.path.join(SERVE_DIR, "tf_disagg_prefill.log"))
        graphs.append(pre_graph)
        decode = GraphProc(root, genv, ["DecodeWorker"], os.path.join(SERVE_DIR, "tf_disagg_decode.log"))
        graphs.append(decode)
        t0 = time.perf_counter()
        while True:
            for g in graphs:
                g.check()
            try:
                up = (pre_graph.lines("prefill_worker") and decode.tail.json_lines("worker")
                      and json.loads(http_call(hport, "GET", "/v1/models", timeout=5)[1])["data"])
            except (OSError, ValueError):
                up = False
            if up:
                break
            if time.perf_counter() - t0 > SERVER_START_S:
                raise SmokeError("the traced disagg graph did not come up")
            time.sleep(0.25)
        out["disagg_start_s"] = time.perf_counter() - t0
        dp, pp = decode.pid("DecodeWorker-0"), pre_graph.pid("PrefillWorker-0")
        got = traced_streams(hport, disagg_bodies, "tfd")
        stats = {**pre_graph.stats([pp]), **decode.stats([dp])}
        d, p = stats[dp], stats[pp]
        corrupted = p["faults_fired"].get("corrupt_kv", 0)
        failed = d["integrity"]["integrity_failures_by_path"]
        refused = failed.get("disagg_frame", 0) + failed.get("disagg_final", 0)
        if corrupted < 1 or refused != corrupted:
            raise SmokeError(f"corrupt_kv: the prefill worker corrupted {corrupted} payloads, the decode "
                             f"worker refused {refused}: {d['integrity']}")
        # every frame sent was received; the refused ones never reached a block
        received = d["transfer"]["frames_rx"]
        if (received != p["transfer"]["frames_tx"] or d["kv_frames_rx"] != received - failed.get(
                "disagg_frame", 0) or d["remote_prefills"] != len(disagg_bodies)):
            raise SmokeError(f"corrupt_kv: frames received {received}, landed {d['kv_frames_rx']}, sent "
                             f"{p['transfer']['frames_tx']}; remote prefills {d['remote_prefills']}")
        if d["remote_fallbacks"] < 1:
            raise SmokeError("corrupt_kv: no shipped prompt was prefilled locally after a refusal")
        doc, by_name, by_id = trace_slices(hport, got[0][1])
        tracks = check_trace("disagg 2000", doc, by_name, by_id, got[0][2], got[0][3],
                             ("http_request", "remote_prefill", "prefill_serve", "kv_frame_tx"), 3)
        hops = ttft_hops(by_name, got[0][4], prefill="remote_prefill")
        ps = by_name["prefill_serve"][0]
        rp = by_name["remote_prefill"][0]
        hops.update(prefill_serve=ps["dur"] / 1e3,
                    remote_to_serve=(ps["ts"] - rp["ts"]) / 1e3,
                    serve_end_to_first=(rp["ts"] + rp["dur"] - ps["ts"] - ps["dur"]) / 1e3,
                    frames=len(by_name["kv_frame_tx"]),
                    kv_frame_tx=sum(e["dur"] for e in by_name["kv_frame_tx"]) / 1e3,
                    kv_land=sum(e["dur"] for e in by_name.get("kv_land", [])) / 1e3,
                    kv_lands=len(by_name.get("kv_land", [])))
        for i, (r, *_rest) in enumerate(got):
            checks.append((f"disagg/{i}", long_ids if i == 0 else ids_of_body(disagg_bodies[i]),
                           r["tokens"], (0, min(KV_CHECK, len(r["tokens"])))))
        out["disagg"] = {"corrupted": corrupted, "refused": refused,
                         "fallbacks": d["remote_fallbacks"], "frames_received": received,
                         "frames_landed": d["kv_frames_rx"],
                         "tracks": tracks, "hops_2000_ms": hops, "start_s": out["disagg_start_s"]}
        log(f"serve_trace_faults/disagg: DYN_FAULT={TF_CORRUPT} on the PrefillWorker: {corrupted} "
            f"payloads corrupted after their checksums, {refused} refused by the decode worker "
            f"(frames {d['integrity']['integrity_failures_by_path'].get('disagg_frame', 0)}, finals "
            f"{d['integrity']['integrity_failures_by_path'].get('disagg_final', 0)}), "
            f"{d['remote_fallbacks']} of {len(disagg_bodies)} prompts prefilled locally; {received} "
            f"frames received (= sent), {d['kv_frames_rx']} landed: the clean ones")
        log(f"serve_trace_faults/disagg: the 2000-token trace over {tracks} process tracks: route -> "
            f"worker {hops['route_to_worker']:.2f} ms, queue_wait {hops['queue_wait']:.2f}, remote_prefill "
            f"{hops['prefill']:.2f} (its start -> prefill_serve {hops['remote_to_serve']:.2f}, prefill_serve "
            f"{hops['prefill_serve']:.2f}, {hops['frames']} kv_frame_tx {hops['kv_frame_tx']:.2f}, "
            f"{hops['kv_lands']} kv_land {hops['kv_land']:.2f}; prefill_serve's end -> the first "
            f"token {hops['serve_end_to_first']:.2f}), first frame back "
            f"{hops['first_frame_back']:.2f}; TTFT {hops['ttft']:.2f} ms ({card})")
    finally:
        for g in reversed(graphs):
            if g.proc.poll() is None:
                g.stop()
        fabric.send_signal(signal.SIGTERM)
        try:
            fabric.wait(30)
        except subprocess.TimeoutExpired:
            fabric.kill()
            fabric.wait(30)
        fab_log.close()
    gc.collect()
    torch.cuda.empty_cache()

    # in this process: the workers' weights (seed 0) on build_torch_engine's
    # defaults (graphed, H = 4)
    engine = build_torch_engine(model_dir, device="cuda", max_model_len=MAX_MODEL_LEN, max_batch=8,
                                num_blocks=2112)
    runner, cfg0 = engine.runner, engine.config
    asyncio.run(engine.close())
    rtok = TokenizerWrapper.from_file(os.path.join(model_dir, "tokenizer.json"))
    ids_of: dict = {}
    for i in range(LLAMA31_8B["vocab_size"]):
        ids_of.setdefault(rtok.decode([i], skip_special_tokens=False), []).append(i)
    gaps = {}
    for tag, prompt, pieces, (lo, hi) in checks:
        try:
            gaps[tag] = kv_reference_check(torch, runner, prompt, pieces, ids_of, n_check=hi, start=lo)
        except SmokeError as e:
            raise SmokeError(f"{tag}, tokens {lo}-{hi}: {e}") from None
    out["reference_max_logit_gap"] = gaps
    log(f"serve_trace_faults: the dense reference on {len(gaps)} streams (a migrated stream's first "
        f"{KV_CHECK} tokens after its cut, the others' and the corrupted disagg ones' first "
        f"{KV_CHECK}): largest logit gap {max(gaps.values()):.4f} (bound 0.25)")

    reqs = make_requests(np, PreprocessedRequest, SamplingOptions, StopConditions)
    eager = dataclasses.replace(cfg0, decode_horizon=1)

    async def lone(cfg, graphed: bool):
        """serve's first request alone: tokens, inter-token gaps, the decode
        label's EMA and the watchdog's trips."""
        prev, runner.cuda_graphs = runner.cuda_graphs, graphed
        eng = TorchEngine(runner, cfg)
        gaps_s: list = []
        try:
            (toks, _, _), = await run_requests(eng, reqs[:1], Context, gaps_s)
            return toks, gaps_s, dict(eng._dispatch_ema), eng.stats.watchdog_trips
        finally:
            await eng.close()
            runner.cuda_graphs = prev

    # (c) slow_decode on the serve_default configuration (eager, H = 1)
    base_toks, base_gaps, base_ema, _ = asyncio.run(lone(eager, False))
    base_toks, base_gaps, base_ema, _ = asyncio.run(lone(eager, False))
    inj = faults.FaultInjector(faults.FaultSpec(slow_decode_factor=TF_SLOW))
    faults.set_injector(inj)
    try:
        slow_toks, slow_gaps, slow_ema, trips = asyncio.run(lone(eager, False))
    finally:
        faults.set_injector(None)
    itl = (statistics.median(base_gaps) * 1e3, statistics.median(slow_gaps) * 1e3)
    ema = (base_ema["decode"] * 1e3, slow_ema["decode"] * 1e3)
    if slow_toks != base_toks or trips or itl[1] < 2.0 * itl[0] or ema[1] < 2.0 * ema[0]:
        raise SmokeError(f"slow_decode={TF_SLOW}: tokens equal {slow_toks == base_toks}, watchdog trips "
                         f"{trips}, ITL {itl}, decode EMA {ema} ms")
    out["slow_decode"] = {"factor": TF_SLOW, "itl_median_ms": itl, "decode_ema_ms": ema,
                          "fired": inj.fired.get("slow_decode", 0), "watchdog_trips": trips}
    log(f"serve_trace_faults/slow_decode={TF_SLOW:g} (serve_default's eager engine): the same "
        f"{len(slow_toks)} tokens; ITL median {itl[0]:.2f} -> {itl[1]:.2f} ms, the decode label's EMA "
        f"{ema[0]:.2f} -> {ema[1]:.2f} ms; the watchdog quiet (trips {trips}) ({card})")

    # (c) abort_after_tokens: every lane fails, every block comes back
    async def abort():
        eng = TorchEngine(runner, eager)
        finals: list = []

        async def one(req):
            async for o in eng.generate(req, Context()):
                if o.finish_reason is not None:
                    finals.append((o.error or {}).get("code"))

        prev, runner.cuda_graphs = runner.cuda_graphs, False
        try:
            faults.set_injector(faults.FaultInjector(faults.FaultSpec(abort_after_tokens=TF_ABORT_AFTER)))
            try:
                await asyncio.gather(*(one(r) for r in reqs))
            finally:
                faults.set_injector(None)
            free = eng.allocator.free_count
            (toks, reason, _), = await run_requests(eng, reqs[:1], Context)
            return finals, free, toks, reason, eng.config.num_blocks
        finally:
            await eng.close()
            runner.cuda_graphs = prev

    finals, free, after_toks, after_reason, nb = asyncio.run(abort())
    if finals.count("injected_fault") != len(reqs) or free != nb - 1 or (
            after_reason is not FinishReason.LENGTH or after_toks != base_toks):
        raise SmokeError(f"abort_after_tokens: finals {finals}, free blocks {free} of {nb - 1}, "
                         f"the next request {after_reason} with {len(after_toks)} tokens")
    out["abort"] = {"after_tokens": TF_ABORT_AFTER, "lanes_failed": len(finals), "free_blocks": free}
    log(f"serve_trace_faults/abort_after_tokens={TF_ABORT_AFTER}: all {len(finals)} lanes failed with "
        f"injected_fault, every block free ({free}), the next request served whole")

    # (d) tracing on against off, in turns, on the graphed B=8 engine-direct serve
    async def serve_once(traced: bool):
        eng = TorchEngine(runner, cfg0)
        try:
            async def one(req):
                ctx = Context()
                with dtrace.root_span("request", ctx, proc="engine"):
                    toks = []
                    async for o in eng.generate(req, ctx):
                        toks.extend(o.token_ids)
                return toks

            dtrace.set_enabled(traced)
            t0 = time.perf_counter()
            outs = await asyncio.gather(*(one(r) for r in reqs))
            wall = time.perf_counter() - t0
            ema = eng._dispatch_ema
            return outs, wall, ema.get(f"decode_multi@H{cfg0.decode_horizon}") or ema["decode"]
        finally:
            dtrace.set_enabled(False)
            await eng.close()

    asyncio.run(serve_once(False))  # captures
    dtrace.reset(proc="engine")
    turns: dict = {"off": [], "on": []}
    outs_seen = {}
    for k in range(TF_TURNS):
        for mode in (("off", "on") if k % 2 == 0 else ("on", "off")):
            outs, wall, step = asyncio.run(serve_once(mode == "on"))
            outs_seen.setdefault(mode, outs)
            turns[mode].append({"tok_s": sum(map(len, outs)) / wall, "step_ms": step * 1e3})
    if outs_seen["on"] != outs_seen["off"]:
        raise SmokeError("tracing on changed the tokens")
    short = [i for i, (t, r) in enumerate(zip(outs_seen["on"], reqs))
             if i != PENALIZED and len(t) != r.stop.max_tokens]
    if short:
        raise SmokeError(f"tracing on / off: requests {short} ended short")
    spans = dtrace.tracer().ring_len()
    if not spans:
        raise SmokeError("tracing on recorded no span")
    med = {m: {k: statistics.median(t[k] for t in v) for k in ("tok_s", "step_ms")}
           for m, v in turns.items()}
    out["tracing_on_off"] = {"turns": turns, "median": med, "spans_recorded": spans,
                             "tok_s_ratio": med["on"]["tok_s"] / med["off"]["tok_s"],
                             "step_ratio": med["on"]["step_ms"] / med["off"]["step_ms"]}
    log(f"serve_trace_faults/tracing: serve's 8 requests on the graphed H {cfg0.decode_horizon} engine, "
        f"{TF_TURNS} turns each: off {med['off']['tok_s']:.1f} tokens/s (step EMA "
        f"{med['off']['step_ms']:.2f} ms), on {med['on']['tok_s']:.1f} ({med['on']['step_ms']:.2f} ms); "
        f"on / off tokens/s {out['tracing_on_off']['tok_s_ratio']:.4f}, step "
        f"{out['tracing_on_off']['step_ratio']:.4f}; {spans} spans recorded; tokens identical ({card})")
    del runner, engine
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"serve_trace_faults: phase {out['phase_s']:.1f} s")
    print(json.dumps({"serve_trace_faults": out}), flush=True)
    return out

# ------------------------------------------------------------------ main


# ------------------------------------------------------------ serve_horizon
#
# The decode horizon on CUDA graphs: build_torch_engine's defaults on a card
# (H = 4; the decode step, the horizon and the verify pass captured once per
# key and replayed per dispatch).

HORIZON = 4
# eight requests one packed prefill admits together (488 of its 512 tokens)
# and that run to 20-64 tokens: an H = 1 engine's decode steps and an H = 4
# engine's step bodies then see the same lanes step by step (a lane frozen
# inside a horizon is fed as an empty lane is), so the two must stream the
# same tokens. On serve's traffic they need not: there prompts are chunked
# beside the decode batch (mixed steps, H = 1 only) and lanes join at other
# steps, and the paged kernels size their splits from every lane's length,
# so a lane's last bits depend on the batch around it.
LOCKSTEP_LENS = [16, 24, 40, 48, 64, 80, 96, 120]
LOCKSTEP_MAX = [20, 64, 33, 47, 26, 58, 41, 35]


def lockstep_requests(np, PreprocessedRequest, SamplingOptions, StopConditions):
    rng = np.random.default_rng(4)
    reqs = []
    for i, (n, m) in enumerate(zip(LOCKSTEP_LENS, LOCKSTEP_MAX)):
        sampling, eos, min_tokens = SamplingOptions(greedy=True), [], None
        if i == SAMPLED:
            sampling = SamplingOptions(temperature=0.8, top_p=0.95, top_k=50, seed=1234)
        if i == PENALIZED:
            sampling = SamplingOptions(greedy=True, **PENALTIES)
            eos, min_tokens = [LLAMA31_8B["eos_token_id"]], MIN_TOKENS
        reqs.append(PreprocessedRequest(
            token_ids=rng.integers(0, LLAMA31_8B["vocab_size"], n).tolist(), sampling=sampling,
            stop=StopConditions(max_tokens=m, min_tokens=min_tokens), eos_token_ids=eos))
    return reqs


def replay_launches(kernels, before: dict, after: dict) -> dict:
    """Kernel launches the replays between two ``graph_stats`` readings
    make: each key's new replays x the launches its capture recorded."""
    want = dict.fromkeys(kernels.KERNELS, 0)
    for key, s in after.items():
        n = s["replays"] - before.get(key, {"replays": 0})["replays"]
        for name, c in s["launches"].items():
            want[name] += n * c
    return want


def serve_runs(torch, engine, runs, Context, kernels):
    """``runs`` [(tag, requests)] through ``engine`` one after another in
    one event loop, then the engine closed. Per run: outputs, wall s, engine
    stats, launch counts (set to 0 just before, read just after), the
    replays' launches and the peak memory."""
    runner = engine.runner

    async def go():
        out = {}
        try:
            for tag, reqs in runs:
                before = runner.graph_stats()
                kernels.reset_launch_counts()
                s0 = stats_dict(engine.stats)
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                outs = await run_requests(engine, reqs, Context)
                wall = time.perf_counter() - t0
                s1 = vars(engine.stats)
                out.setdefault(tag, []).append({
                    "outs": outs, "wall": wall,
                    "stats": {k: v - s0[k] for k, v in s1.items() if isinstance(v, int)},
                    "launches": kernels.launch_counts(),
                    "replayed": replay_launches(kernels, before, runner.graph_stats()),
                    "peak": torch.cuda.max_memory_allocated()})
        finally:
            await engine.close()
        return out

    return asyncio.run(go())


def check_outputs(tag, first, reqs, FinishReason, vocab: int = LLAMA31_8B["vocab_size"]) -> None:
    for i, ((toks, reason, _), req) in enumerate(zip(first, reqs)):
        if req.stop.min_tokens:
            ok = len(toks) >= req.stop.min_tokens and reason in (FinishReason.LENGTH,
                                                                 FinishReason.EOS)
        else:
            ok = reason is FinishReason.LENGTH and len(toks) == req.stop.max_tokens
        if not ok or not all(0 <= t < vocab for t in toks):
            raise SmokeError(f"{tag} request {i}: {len(toks)} tokens, reason {reason}")


def check_horizon_launches(tag, run, L, kernels, attn, eager=None) -> None:
    """Every launch of a graphed horizon run came from a replay (or from the
    run's eager prefills: ``eager``, name -> launches): the counts equal
    replays x captured launches, and the decode attention (``attn``) ran
    once per layer and step body, frozen steps included."""
    st = run["stats"]
    if st["horizon_dispatches"] <= 0 or st["horizon_degrades"] or st["mixed_steps"]:
        raise SmokeError(f"{tag}: no horizon, a degrade or a mixed step: {st}")
    if st["graph_replays"] != st["horizon_dispatches"] + st["decode_steps"] + st["verify_steps"]:
        raise SmokeError(f"{tag}: {st['graph_replays']} replays for {st} dispatches")
    want = dict(run["replayed"])
    for name, n in (eager or {}).items():
        want[name] += n
    if run["launches"] != want:
        raise SmokeError(f"{tag}: launches {run['launches']} != replays x captured "
                         f"(+ eager prefills) {want}")
    bodies = st["decode_steps"] + st["horizon_steps"] + st["verify_chained_steps"]
    if run["launches"][attn] != L * bodies:
        raise SmokeError(f"{tag}: {attn} launched {run['launches'][attn]} != {L} x {bodies} "
                         "step bodies")


def rate(run) -> float:
    return sum(len(t) for t, _, _ in run["outs"]) / run["wall"]


def step_case(np, runner, seed: int = 12, B: int = 8):
    """The B=8 step (or B lanes) at context 1024 of the engine phases:
    lanes' tables, positions, slots and tokens."""
    rng = np.random.default_rng(seed)
    bs, ctx = runner.block_size, STEP_CTX
    per = (ctx + 1 + bs - 1) // bs
    tables = np.zeros((B, runner.max_blocks_per_seq), np.int32)
    for b in range(B):
        tables[b, :per] = np.arange(1 + b * per, 1 + (b + 1) * per)
    pos = np.full(B, ctx, np.int64)
    slots = tables[np.arange(B), pos // bs].astype(np.int64) * bs + pos % bs
    return rng.integers(0, runner.config.vocab_size, B), pos, tables, slots


def graph_step_times(torch, np, runners: dict) -> dict:
    """The B=8 decode step (model + sampling + fetch) at context 1024 of
    each runner, eager and graphed in turns (eager, graphed, graphed,
    eager): wall (host clock around work ending in the fetch), device time
    (torch.profiler) and host time (launching, not waiting: the eager
    step's ops; the graphed step's upload + replay)."""
    out = {}
    for name, r in runners.items():
        toks, pos, tables, slots = step_case(np, r)
        B = len(toks)
        zeros, ones, kz = np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int64)

        def step():
            return r.fetch_sample(r.decode(toks, pos, tables, slots, zeros, ones, kz))

        walls = {False: [], True: []}
        for graphed in (False, True):
            r.cuda_graphs = graphed
            for _ in range(2):
                step()
            for _ in range(6):
                t0 = time.perf_counter()
                step()
                walls[graphed].append((time.perf_counter() - t0) * 1e3)
        row = {}
        for graphed in (False, True):
            r.cuda_graphs = graphed
            dev_ms, _ = profile_calls(torch, step, calls=3)
            if graphed:
                step()
                host = host_ms(torch, lambda: r.launch_graph("decode"), reps=10)
            else:
                host = host_ms(torch, lambda: r.decode(toks, pos, tables, slots, zeros, ones, kz),
                               reps=10)
            w = walls[graphed]
            row["graphed" if graphed else "eager"] = {
                "median": statistics.median(w), "min": min(w), "max": max(w),
                "device_ms": dev_ms, "host_ms": host}
        r.cuda_graphs = True
        out[name] = row
    return out


def replay_vs_eager(torch, np, runner, tag: str, eos_id: int = LLAMA31_8B["eos_token_id"]) -> dict:
    """Each graph (decode H 1, decode_multi H 4, verify S 4 with E 3) replayed
    against the same call made eagerly, on the same cache contents (restored
    between the two): bitwise. Lanes hold the B=8 step's context 1024; half
    the lanes sample."""
    toks, pos, tables, slots = step_case(np, runner, seed=13)
    B = len(toks)
    temps = np.where(np.arange(B) % 2 == 0, 0.0, 0.8).astype(np.float32)
    top_ps, top_ks = np.full(B, 0.95, np.float32), np.full(B, 50, np.int64)
    keys = np.stack([np.arange(B) + 5, np.arange(B)], 1).astype(np.int64)
    active = np.ones(B, bool)
    limit = np.array([4, 4, 2, 4, 1, 4, 3, 4], np.int64)
    no_min = np.zeros(B, np.int64)
    eos = np.full((B, 4), -1, np.int64)
    eos[:, 0] = eos_id
    drafts = np.random.default_rng(14).integers(0, runner.config.vocab_size, (B, 3))
    dlen = np.array([3, 1, 0, 2, 3, 3, 1, 2], np.int64)
    calls = {
        "decode": lambda: np.concatenate([a.reshape(-1) for a in runner.fetch_sample(
            runner.decode(toks, pos, tables, slots, temps, top_ps, top_ks, keys=keys))]),
        "decode_multi": lambda: runner.decode_multi(
            HORIZON, toks, pos, tables, temps, top_ps, top_ks, keys, active, limit, no_min,
            eos).cpu().numpy(),
        "verify": lambda: runner.spec_verify(
            SPEC_K, HORIZON - 1, toks, drafts, dlen, pos, tables, temps, top_ps, top_ks, keys,
            active, np.full(B, 16, np.int64), no_min, eos).cpu().numpy(),
    }
    leaves = [t for c in (runner.k_cache, runner.v_cache)
              for t in (c.values() if isinstance(c, dict) else (c,))]
    snap = [t.clone() for t in leaves]
    res = {}
    for name, call in calls.items():
        out = {}
        for graphed in (False, True):
            runner.cuda_graphs = graphed
            out[graphed] = call()
            for t, s in zip(leaves, snap):
                t.copy_(s)
        runner.cuda_graphs = True
        diff = int((out[False] != out[True]).sum())
        if diff or not np.isfinite(out[True]).all():
            raise SmokeError(f"serve_horizon/{tag}: the {name} graph's replay differs from the "
                             f"eager call in {diff} of {out[True].size} values")
        res[name] = out[True].shape
    del snap
    return res


def phase_serve_horizon(torch, np, card: str, params, fused_runner, int8_runner,
                        spec_reqs) -> dict:
    """The decode horizon on CUDA graphs (see the module docstring, phase
    12). ``params``: the serve phase's bf16 weights; ``fused_runner``: the
    spec phase's fused bf16 runner; ``int8_runner``: serve_int8's runner
    (int8 weights, int8 cache, fused heads); ``spec_reqs``: the spec phase's
    quoting traffic."""
    from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner
    from dynamo_tpu_torch.ops import kernels
    from dynamo_tpu_torch.protocols.common import (
        Context, FinishReason, PreprocessedRequest, SamplingOptions, StopConditions,
    )

    t_phase = time.perf_counter()
    L = MAIN_LAYERS
    reqs = make_requests(np, PreprocessedRequest, SamplingOptions, StopConditions)
    lock = lockstep_requests(np, PreprocessedRequest, SamplingOptions, StopConditions)
    res = {"card": card}

    # 1. build_torch_engine's defaults over the serve phase's weights
    engine = build_torch_engine(MAIN_MODEL, device="cuda", max_batch=8,
                                max_model_len=MAX_MODEL_LEN, seed=0, params=params)
    runner = engine.runner
    cfg0 = engine.config
    if not (cfg0.decode_horizon == HORIZON and runner.cuda_graphs and not cfg0.lazy_horizon
            and cfg0.spec_k == 0 and not runner.config.fused_decode):
        raise SmokeError(f"serve_horizon: the defaults are H {cfg0.decode_horizon}, graphs "
                         f"{runner.cuda_graphs}; expected H {HORIZON} on graphs")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    g4 = serve_runs(torch, engine, [("serve", reqs), ("serve", reqs), ("lock", lock)],
                    Context, kernels)
    mem_graphs = torch.cuda.memory_allocated() - mem0
    check_outputs("serve_horizon", g4["serve"][0]["outs"], reqs, FinishReason)
    for run in g4["serve"] + g4["lock"]:
        check_horizon_launches("serve_horizon", run, L, kernels, "paged_decode_attention")
    if [t for t, _, _ in g4["serve"][1]["outs"]] != [t for t, _, _ in g4["serve"][0]["outs"]]:
        raise SmokeError("serve_horizon: the repeated run gave other tokens")
    gap = max(reference_check(torch, runner, reqs[i].token_ids, g4["serve"][0]["outs"][i][0])
              for i in (0, -1))
    log(f"serve_horizon: graphed H {HORIZON} served at {time.perf_counter() - t_phase:.1f} s")

    def again(H, graphed, runs):
        runner.cuda_graphs = graphed
        eng = TorchEngine(runner, dataclasses.replace(cfg0, decode_horizon=H))
        out = serve_runs(torch, eng, runs, Context, kernels)
        runner.cuda_graphs = True
        return out

    # 2. the same runner eagerly: at H = 4 the same tokens on serve's traffic
    # (graphs change nothing), at H = 1 the same on the lockstep traffic
    e4 = again(HORIZON, False, [("serve", reqs)])
    e1 = again(1, False, [("lock", lock), ("serve", reqs)])
    toks = {k: [t for t, _, _ in v["outs"]] for k, v in (
        ("g4", g4["serve"][0]), ("e4", e4["serve"][0]), ("g4_lock", g4["lock"][0]),
        ("e1_lock", e1["lock"][0]), ("e1", e1["serve"][0]))}
    if toks["g4"] != toks["e4"]:
        raise SmokeError("serve_horizon: graphed and eager H = 4 engines streamed other tokens")
    if toks["g4_lock"] != toks["e1_lock"]:
        bad = [i for i, (a, b) in enumerate(zip(toks["g4_lock"], toks["e1_lock"])) if a != b]
        raise SmokeError(f"serve_horizon: graphed H = 4 and eager H = 1 differ on lockstep "
                         f"requests {bad}")
    check_outputs("serve_horizon/lockstep", g4["lock"][0]["outs"], lock, FinishReason)
    agree = sum(a == b for x, y in zip(toks["g4"], toks["e1"]) for a, b in zip(x, y)) / sum(
        len(x) for x in toks["e1"])
    peaks = {"graphed_h4": g4["serve"][1]["peak"] - mem0, "eager_h4": e4["serve"][0]["peak"] - mem0}

    # 3. serve tokens/s: eager H 1 and graphed H 4 from the runs above (the
    # graphed one warm), graphed H 1 once its single-step keys are captured
    g1 = again(1, True, [("serve", reqs)])  # captures the single-step keys
    walls = {"eager_h1": [e1["serve"][0]], "graphed_h4": [g4["serve"][1]],
             "graphed_h1": [again(1, True, [("serve", reqs)])["serve"][0]]}
    serve_rate = {k: statistics.mean(rate(r) for r in v) for k, v in walls.items()}
    log(f"serve_horizon: bf16 compared and timed at {time.perf_counter() - t_phase:.1f} s")
    # decode dispatches, each one fetch: tokens per fetch
    fetches = {k: sum(v[0]["stats"][n] for n in ("horizon_dispatches", "decode_steps",
                                                 "mixed_steps")) for k, v in walls.items()}
    del g1

    # 4. the int8 deployment: serve_int8's runner (int8 weights and cache,
    # fused heads) as build_torch_engine's defaults would drive it
    icfg = dataclasses.replace(cfg0, num_blocks=int8_runner.num_blocks)
    int8_runner.cuda_graphs = True
    ig4 = serve_runs(torch, TorchEngine(int8_runner, icfg),
                     [("serve", reqs), ("lock", lock)], Context, kernels)
    check_outputs("serve_horizon/int8", ig4["serve"][0]["outs"], reqs, FinishReason)
    for run in ig4["serve"] + ig4["lock"]:
        check_horizon_launches("serve_horizon/int8", run, L, kernels,
                               "paged_decode_attention_int8")
    int8_runner.cuda_graphs = False
    ie1 = serve_runs(torch, TorchEngine(int8_runner, dataclasses.replace(icfg, decode_horizon=1)),
                     [("lock", lock)], Context, kernels)
    int8_runner.cuda_graphs = True
    if [t for t, _, _ in ig4["lock"][0]["outs"]] != [t for t, _, _ in ie1["lock"][0]["outs"]]:
        raise SmokeError("serve_horizon/int8: graphed H = 4 and eager H = 1 differ on the "
                         "lockstep requests")
    int8_launches = ig4["serve"][0]["launches"]
    log(f"serve_horizon: int8 compared at {time.perf_counter() - t_phase:.1f} s")

    # 5. every graph's replay against its eager call, bitwise, both forms
    bitwise = {"bf16": replay_vs_eager(torch, np, runner, "bf16"),
               "int8": replay_vs_eager(torch, np, int8_runner, "int8")}

    # 6. spec tokens/s with E = 0 (H 1) against E = 3 (H 4), graphed, over
    # the spec phase's quoting traffic (fused bf16 runner)
    fused_runner.cuda_graphs = True
    scfg = dataclasses.replace(cfg0, num_blocks=fused_runner.num_blocks, spec_k=SPEC_K,
                               spec_min_coverage=SPEC_COVERAGE)
    spec_runs = {}
    for name in ("e0", "e3", "e3", "e0"):  # the first of each warms its graphs
        H = HORIZON if name == "e3" else 1
        spec_runs.setdefault(name, []).append(serve_runs(
            torch, TorchEngine(fused_runner, dataclasses.replace(scfg, decode_horizon=H)),
            [("spec", spec_reqs)], Context, kernels)["spec"][0])
    st3 = spec_runs["e3"][-1]["stats"]
    if st3["verify_steps"] <= 0 or st3["verify_chained_steps"] != (HORIZON - 1) * st3["verify_steps"]:
        raise SmokeError(f"serve_horizon/spec: no chained verify dispatches: {st3}")
    # every launch but the eager prefills' (#3, chunking off) from a replay
    spec_launches = spec_runs["e3"][-1]["launches"]
    want = dict(spec_runs["e3"][-1]["replayed"])
    want["flash_prefill_attention"] += L * st3["prefills"]
    if spec_launches != want:
        raise SmokeError(f"serve_horizon/spec: launches {spec_launches} != replays x captured "
                         f"+ prefills {want}")
    spec_rate = {k: statistics.mean(rate(r) for r in v[1:]) for k, v in spec_runs.items()}
    log(f"serve_horizon: spec timed at {time.perf_counter() - t_phase:.1f} s")

    # 7. the B=8 step, eager against graphed, fused and unfused, both forms
    int8_unfused = TorchModelRunner(
        dataclasses.replace(int8_runner.config, fused_decode=False), int8_runner.params, num_blocks=8 * (STEP_CTX // BLOCK + 1) + 1, block_size=BLOCK,
        max_batch=8, max_model_len=MAX_MODEL_LEN, device="cuda", kv_dtype="int8")
    steps = graph_step_times(torch, np, {"bf16_unfused": runner, "bf16_fused": fused_runner,
                                         "int8_unfused": int8_unfused, "int8_fused": int8_runner})
    del int8_unfused
    captures = {"bf16_unfused": runner.graph_stats(), "bf16_fused": fused_runner.graph_stats(),
                "int8_fused": int8_runner.graph_stats()}
    for r in (fused_runner, int8_runner):
        r.cuda_graphs = False  # as their own phases left them
    res.update({
        "serve_graphed_h4": {"stats": g4["serve"][0]["stats"], "wall_s_cold": g4["serve"][0]["wall"],
                             "wall_s_warm": g4["serve"][1]["wall"],
                             "launches": g4["serve"][0]["launches"], "reference_max_logit_gap": gap},
        "tokens_equal": {"graphed_h4_vs_eager_h4_serve": True,
                         "graphed_h4_vs_eager_h1_lockstep_bf16": True,
                         "graphed_h4_vs_eager_h1_lockstep_int8": True,
                         "share_equal_graphed_h4_vs_eager_h1_serve": agree},
        "serve_tok_per_s": serve_rate, "serve_decode_fetches": fetches,
        "serve_tokens_per_fetch": {k: sum(len(t) for t, _, _ in walls[k][0]["outs"]) / n
                                   for k, n in fetches.items()},
        "serve_tokens_per_horizon": g4["serve"][1]["stats"]["horizon_tokens"]
        / max(1, g4["serve"][1]["stats"]["horizon_dispatches"]),
        "spec_tok_per_s": spec_rate, "spec_stats_e3": st3, "spec_launches_e3": spec_launches,
        "int8_launches": int8_launches, "replay_vs_eager_bitwise": {
            k: {n: list(s) for n, s in v.items()} for k, v in bitwise.items()},
        "step_ms_B8": steps,
        "capture_s": {k: {key: s["capture_s"] for key, s in v.items()} for k, v in captures.items()},
        "graph_mem_bytes": mem_graphs, "serve_peak_mem_bytes": peaks,
        "phase_s": time.perf_counter() - t_phase,
    })
    print(json.dumps({"serve_horizon": res, "card": card}), flush=True)
    log(f"serve_horizon: defaults H {HORIZON} on graphs; serve {g4['serve'][1]['wall']:.2f} s warm, "
        f"{res['serve_tokens_per_horizon']:.2f} tokens a horizon; graphed H4 = eager H4 tokens, "
        f"lockstep graphed H4 = eager H1 tokens (bf16, int8), {100 * agree:.1f}% equal on serve "
        f"traffic; every replay bitwise = eager; tokens/s eager H1 {serve_rate['eager_h1']:.1f}, "
        f"graphed H1 {serve_rate['graphed_h1']:.1f}, graphed H4 {serve_rate['graphed_h4']:.1f} "
        f"(fetches {fetches}); spec E0 {spec_rate['e0']:.1f} / E3 {spec_rate['e3']:.1f}; graphs "
        f"hold {mem_graphs / 1e6:.1f} MB; phase {res['phase_s']:.1f} s ({card})")
    for name, row in steps.items():
        log(f"serve_horizon: B=8 step {name}: eager {row['eager']['median']:.2f} ms wall / "
            f"{row['eager']['device_ms']:.2f} device / {row['eager']['host_ms']:.2f} host; graphed "
            f"{row['graphed']['median']:.2f} / {row['graphed']['device_ms']:.2f} / "
            f"{row['graphed']['host_ms']:.3f} ({card})")
    res["launches"] = g4["serve"][0]["launches"]
    return res


# ---------------------------------------------------------- serve_disagg

# the reference's DisaggConfig(): prompts longer than this ship
DISAGG_LOCAL_MAX = 50
TTFT_ROUNDS = 1  # of local, disagg, disagg, local


class LandingProbe:
    """Holds every landing of a leg to the blocks the prefill engine wrote.
    While armed, the prefill engine's scratch blocks are known by prompt and
    position (its ``_prefill_request``), and each of its block reads (the
    extracts) first copies the blocks it reads on the card. Each inject of
    the decode runner then compares every block it landed with the copy of
    the same prompt's same block, found through the decode engine's sequence
    that holds the landed blocks: bitwise for bf16 and for int8 mantissas
    and scales moved verbatim; an int8 block quantized again on landing (the
    device path dequantizes to bf16) within one quantization step. A landed
    block with no copy fails."""

    def __init__(self, torch, prefill, decode) -> None:
        self.torch = torch
        self.decode = decode
        self.owner: dict = {}  # prefill scratch block -> (prompt, block index)
        self.src: dict = {}  # (prompt, block index) -> (copied blocks, column)
        self.landings: list = []
        self.armed = False
        real = prefill._prefill_request

        def alloc(req):
            ids, error = real(req)
            if self.armed:
                prompt = tuple(req.token_ids)
                self.owner.update({b: (prompt, i) for i, b in enumerate(ids)})
            return ids, error

        prefill._prefill_request = alloc
        pr, dr = prefill.runner, decode.runner
        for name in ("extract_blocks", "extract_blocks_quant", "extract_blocks_device"):
            setattr(pr, name, self._stash(pr, getattr(pr, name)))
        for name in ("inject_blocks", "inject_blocks_quant", "inject_blocks_device"):
            setattr(dr, name, self._check(dr, getattr(dr, name), name))

    def arm(self) -> None:
        self.owner, self.src, self.landings, self.armed = {}, {}, [], True

    def disarm(self) -> dict:
        """Stops the probe, frees its copies and returns the leg's landings
        summed: per prompt length the landings and the blocks compared."""
        self.armed, self.src, self.owner = False, {}, {}
        rows = self.landings
        per_prompt: dict = {}
        for r in rows:
            n = per_prompt.setdefault(r.get("prompt_len", 0), [0, 0])
            n[0] += 1
            n[1] += r["blocks"]
        return {"ok": bool(rows) and all(r["ok"] for r in rows), "landings": len(rows),
                "blocks": sum(r["blocks"] for r in rows), "via": sorted({r["via"] for r in rows}),
                "bitwise": all(r.get("bitwise", False) for r in rows),
                "max_mantissa_step": max((r.get("max_mantissa_step", 0) for r in rows), default=0),
                "max_scale_rel": max((r.get("max_scale_rel", 0.0) for r in rows), default=0.0),
                "per_prompt": per_prompt, "failed": [r for r in rows if not r["ok"]][:3]}

    def _blocks(self, runner, ids):
        idx = self.torch.tensor(list(ids), device=runner.device)
        caches = (runner.k_cache, runner.v_cache)
        if runner.kv_quantized:
            return [c[p].index_select(2, idx) for c in caches for p in ("q", "s")]
        return [c.index_select(2, idx) for c in caches]

    def _stash(self, runner, real):
        def stash(ids, *a, **k):
            if self.armed:
                blocks = self._blocks(runner, ids)
                for j, b in enumerate(ids):
                    self.src[self.owner[b]] = (blocks, j)
            return real(ids, *a, **k)
        return stash

    def _check(self, runner, real, name):
        def check(ids, *a, **k):
            out = real(ids, *a, **k)
            if self.armed:
                self.landings.append(self._landing(runner, list(ids), name))
            return out
        return check

    def _landing(self, runner, ids, name) -> dict:
        row = {"via": name, "blocks": len(ids)}
        seq = next((s for s in list(self.decode.slots) if s is not None and ids[0] in s.block_ids),
                   None)
        if seq is None:
            return {**row, "ok": False, "why": "no sequence holds the landed blocks"}
        prompt = tuple(seq.token_ids[:seq.num_prompt])
        first = seq.block_ids.index(ids[0])
        row.update(prompt_len=len(prompt), first_block=first)
        keys = [(prompt, first + j) for j in range(len(ids))]
        missing = [first + j for j, key in enumerate(keys) if key not in self.src]
        if seq.block_ids[first:first + len(ids)] != ids or missing:
            return {**row, "ok": False, "why": f"no copy of blocks {missing[:4]} or not in order"}
        got = self._blocks(runner, ids)
        want = [self.torch.cat([self.src[key][0][t].narrow(2, self.src[key][1], 1)
                                for key in keys], dim=2) for t in range(len(got))]
        return {**row, **self._compare(got, want, name)}

    def _compare(self, got, want, name) -> dict:
        torch = self.torch
        if len(got) == 2 or name == "inject_blocks_quant":
            return {"bitwise": True, "ok": all(torch.equal(g, w) for g, w in zip(got, want))}
        # int8 quantized again on landing: (q, s) of K, then of V
        steps, rel, ok = 0, 0.0, True
        for (q1, s1), (q0, s0) in zip((got[:2], got[2:]), (want[:2], want[2:])):
            steps = max(steps, int((q1.int() - q0.int()).abs().max()))
            rel = max(rel, float(((s1 - s0).abs() / s0.clamp_min(1e-30)).max()))
            d1 = q1.float() * s1[..., None, None]
            d0 = q0.float() * s0[..., None, None]
            ok &= bool(((d1 - d0).abs() <= 1.01 * s0[..., None, None] + 1e-6).all())
        return {"bitwise": False, "ok": ok, "max_mantissa_step": steps, "max_scale_rel": rel}


def cache_ptrs(runner) -> list:
    return [t.data_ptr() for c in (runner.k_cache, runner.v_cache)
            for t in (c.values() if isinstance(c, dict) else (c,))]


def _int_stats(stats) -> dict:
    return {k: v for k, v in vars(stats).items() if isinstance(v, int)}


async def serve_leg(torch, engine, reqs, Context, kernels, probe=None, prefill=None) -> dict:
    """The requests through ``engine`` as it is set up; counters set to 0
    just before, read just after; every inter-token gap kept."""
    before = engine.runner.graph_stats()
    s0 = _int_stats(engine.stats)
    p0 = _int_stats(prefill.stats) if prefill is not None else {}
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    if probe is not None:
        probe.arm()
    gaps: list = []
    t0 = time.perf_counter()
    try:
        outs = await run_requests(engine, reqs, Context, gaps)
    finally:
        landing = probe.disarm() if probe is not None else None
    wall = time.perf_counter() - t0
    return {
        "outs": outs, "wall": wall, "launches": kernels.launch_counts(),
        "replayed": replay_launches(kernels, before, engine.runner.graph_stats()),
        "stats": {k: v - s0[k] for k, v in _int_stats(engine.stats).items()},
        "prefill_stats": ({k: v - p0[k] for k, v in _int_stats(prefill.stats).items()}
                          if prefill is not None else {}),
        "peak": torch.cuda.max_memory_allocated(), "landing": landing, "gaps": gaps,
    }


def gap_stats(gaps) -> dict:
    """Inter-token gaps (s) of every request of a run, in ms: p50, p99, the
    largest and the mean. A horizon of H delivers its tokens together, so
    most gaps inside one are near 0; p99 and the largest show the stalls."""
    ms = sorted(g * 1e3 for g in gaps)
    return {"n": len(ms), "p50_ms": statistics.median(ms),
            "p99_ms": statistics.quantiles(ms, n=100, method="inclusive")[98], "max_ms": ms[-1],
            "mean_ms": statistics.fmean(ms)}


def leg_row(run) -> dict:
    tokens = sum(len(t) for t, _, _ in run["outs"])
    return {"stats": run["stats"], "launches": run["launches"], "wall_s": run["wall"],
            "output_tok_per_s": tokens / run["wall"], "peak_mem_bytes": run["peak"],
            "itl": gap_stats(run["gaps"]), "ttft_s_concurrent": [t for _, _, t in run["outs"]]}


def check_local_leg(tag, run, reqs, L, kernels, attn, FinishReason, single_shot: bool) -> dict:
    """A single engine serving the requests itself: outputs, no remote
    prefill, every launch a replay but #3 (L x its single-shot prefills
    when ``single_shot``, else none: chunks)."""
    check_outputs(tag, run["outs"], reqs, FinishReason)
    st = run["stats"]
    if st["remote_prefills"] or st["remote_fallbacks"] or bool(st["prefills"]) != single_shot:
        raise SmokeError(f"{tag}: not a local {'single-shot' if single_shot else 'chunked'} "
                         f"engine: {st}")
    check_horizon_launches(tag, run, L, kernels, attn,
                           eager={"flash_prefill_attention": L * st["prefills"]})
    return leg_row(run)


def check_disagg_leg(torch, tag, run, decode, reqs, ptrs, attn, want3, bound, FinishReason,
                     kernels, host, frames) -> dict:
    """Every check of one leg (see the module docstring, phase 14)."""
    L = MAIN_LAYERS
    check_outputs(tag, run["outs"], reqs, FinishReason)
    st, pst = run["stats"], run["prefill_stats"]
    shipped = [len(r.token_ids) for r in reqs if len(r.token_ids) > DISAGG_LOCAL_MAX]
    local = len(reqs) - len(shipped)
    if st["remote_prefills"] != len(shipped) or st["remote_fallbacks"]:
        raise SmokeError(f"{tag}: {st['remote_prefills']} remote prefills, "
                         f"{st['remote_fallbacks']} local fallbacks; expected {len(shipped)} and 0")
    if st["prefills"] or st["chunk_steps"] or st["packed_prefills"] != local \
            or pst["prefills_served"] != len(shipped):
        raise SmokeError(f"{tag}: a local prefill of a shipped prompt: decode {st}, "
                         f"prefill {pst}")
    check_horizon_launches(tag, run, L, kernels, attn, eager={"flash_prefill_attention": want3})
    landing = run["landing"]
    # every block of every shipped prompt compared, in one landing per
    # prompt, or, streamed, one more per frame
    want_blocks = {T: -(-T // BLOCK) for T in shipped}
    if not landing["ok"] or {T: n[1] for T, n in landing["per_prompt"].items()} != want_blocks:
        raise SmokeError(f"{tag}: landed blocks differ from the prefill engine's or were not "
                         f"all compared (want {want_blocks}): {landing}")
    frames_rx = st["kv_frames_rx"]
    if landing["landings"] != len(shipped) + frames_rx:
        raise SmokeError(f"{tag}: {landing['landings']} landings compared for {len(shipped)} "
                         f"prompts and {frames_rx} frames")
    if frames and any(n[0] < 2 for T, n in landing["per_prompt"].items() if T > 512):
        raise SmokeError(f"{tag}: a prompt over one chunk landed without a frame: {landing}")
    if cache_ptrs(decode.runner) != ptrs:
        raise SmokeError(f"{tag}: the decode cache moved; its graphs read stale blocks")
    if host and not st["kv_wire_bytes_rx"] == pst["kv_wire_bytes_tx"] > 0:
        raise SmokeError(f"{tag}: {st['kv_wire_bytes_rx']} payload bytes landed of "
                         f"{pst['kv_wire_bytes_tx']} shipped")
    if frames != (frames_rx > 0) or frames_rx != pst["kv_frames_tx"]:
        raise SmokeError(f"{tag}: {frames_rx} frames landed of {pst['kv_frames_tx']}")
    if not host and (st["kv_wire_bytes_rx"] or pst["kv_wire_bytes_tx"]):
        raise SmokeError(f"{tag}: the device path used the wire codec")
    gap = max(reference_check(torch, decode.runner, r.token_ids, run["outs"][i][0], bound=bound)
              for i, r in enumerate(reqs) if i not in (SAMPLED, PENALIZED))
    return {**leg_row(run), "prefill_stats": pst, "landing": landing,
            "reference_max_logit_gap": gap, "reference_bound": bound, "shipped": len(shipped)}


async def ttft_s(engine, req, Context) -> float:
    """Wall time to the first token of ``req`` alone (max_tokens 1), the
    engine idle before and after."""
    t0 = time.perf_counter()
    async for out in engine.generate(req, Context()):
        if out.token_ids:
            break
    t = time.perf_counter() - t0
    while any(s is not None for s in engine.slots) or engine.waiting:
        await asyncio.sleep(0.005)
    return t


async def profiled_ttft(torch, engine, req, Context) -> tuple[float, dict]:
    """One TTFT under torch.profiler: the card's kernel time until the
    first token (every engine on the card), by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        await ttft_s(engine, req, Context)
        torch.cuda.synchronize()
    kernels = {
        e.key: (getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0),
                e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key
    }
    return sum(us for us, _ in kernels.values()) / 1e3, kernels


def block_move_times(torch, prefill, decode, n_blocks: int) -> dict:
    """The device path's two copies of one n-block prompt (the extract on
    the prefill runner, the inject on the decode runner), CUDA-event
    medians with L2 flushed, beside their byte bound (each reads n blocks
    of K and V and writes them once) and the one PyTorch call each is
    (index_select / index_copy_ of both caches)."""
    flush = make_flush(torch)
    ids = list(range(1, n_blocks + 1))
    idx = torch.tensor(ids, device="cuda")
    k, v, _ = prefill.runner.extract_blocks_device(ids)
    nbytes = k.numel() * k.element_size() + v.numel() * v.element_size()
    bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    pk, pv, dk, dv = prefill.runner.k_cache, prefill.runner.v_cache, decode.runner.k_cache, \
        decode.runner.v_cache
    rows = {
        "extract": time_ms(torch, lambda: prefill.runner.extract_blocks_device(ids), flush=flush),
        "inject": time_ms(torch, lambda: decode.runner.inject_blocks_device(ids, k, v),
                          flush=flush),
        "index_select": time_ms(torch, lambda: (pk.index_select(2, idx), pv.index_select(2, idx)),
                                flush=flush),
        "index_copy_": time_ms(torch, lambda: (dk.index_copy_(2, idx, k), dv.index_copy_(2, idx, v)),
                               flush=flush),
    }
    return {"blocks": n_blocks, "kv_bytes": nbytes, "bound_ms_each": bound, "bound_by": "bytes",
            **rows}


def host_payload_split(torch, prefill, decode, n_blocks: int, reps: int = 3) -> dict:
    """The host legs' steps for one n-block bf16 payload, host clock,
    medians of ``reps``: the extract to the host (gather + device-to-host
    copy), the encode (bytes + checksums), the checksums alone, the decode
    (verify + views) and the inject (host-to-device copy + scatter)."""
    from dynamo_tpu_torch import integrity
    from dynamo_tpu_torch.disagg.protocols import KvBlockPayload

    ids = list(range(1, n_blocks + 1))
    steps = {"d2h": [], "encode": [], "checksum": [], "decode": [], "h2d": []}
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        k, v = prefill.runner.extract_blocks(ids)
        steps["d2h"].append(time.perf_counter() - t)
        t = time.perf_counter()
        payload = KvBlockPayload.encode(k, v, "raw", "bfloat16")
        steps["encode"].append(time.perf_counter() - t)
        t = time.perf_counter()
        integrity.checksum(payload.k_bytes)
        integrity.checksum(payload.v_bytes)
        steps["checksum"].append(time.perf_counter() - t)
        t = time.perf_counter()
        kd, vd = payload.decode()
        steps["decode"].append(time.perf_counter() - t)
        t = time.perf_counter()
        decode.runner.inject_blocks(ids, kd, vd)
        torch.cuda.synchronize()
        steps["h2d"].append(time.perf_counter() - t)
    return {"blocks": n_blocks, "wire_bytes": payload.wire_nbytes, "checksum": integrity.ALGO,
            **{f"{k}_ms": statistics.median(v) * 1e3 for k, v in steps.items()}}


def phase_serve_disagg(torch, np, card: str, params, int8_params) -> dict:
    """Disaggregated prefill/decode on one card (see the module docstring,
    phase 14). ``params``: the serve phase's bf16 weights; ``int8_params``:
    serve_int8's int8 weights. Both engines of a pair come from
    build_torch_engine's defaults and share the weights."""
    from dynamo_tpu_torch.disagg.colocated import ColocatedPrefillClient, HostPrefillClient
    from dynamo_tpu_torch.disagg.router import DisaggConfig, DisaggregatedRouter
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.ops import kernels
    from dynamo_tpu_torch.protocols.common import (
        Context, FinishReason, PreprocessedRequest, SamplingOptions, StopConditions,
    )

    t_phase = time.perf_counter()
    L = MAIN_LAYERS
    reqs = make_requests(np, PreprocessedRequest, SamplingOptions, StopConditions)
    if DisaggConfig().max_local_prefill_length != DISAGG_LOCAL_MAX:
        raise SmokeError("serve_disagg: DisaggConfig's default threshold moved")
    shipped = [r for r in reqs if len(r.token_ids) > DISAGG_LOCAL_MAX]
    one_shot = sum(1 for r in shipped if len(r.token_ids) <= 512)  # prefill_only_stream's
    longest = max(reqs, key=lambda r: len(r.token_ids))
    n_long = -(-len(longest.token_ids) // BLOCK)
    ttft_req = PreprocessedRequest(token_ids=longest.token_ids,
                                   sampling=SamplingOptions(greedy=True),
                                   stop=StopConditions(max_tokens=1))

    def build(**kw):
        return build_torch_engine(MAIN_MODEL, device="cuda", max_batch=8,
                                  max_model_len=MAX_MODEL_LEN, seed=0, **kw)

    def pair(**kw):
        decode, prefill = build(**kw), build(**kw)
        cfg = decode.config
        if not (cfg.decode_horizon == HORIZON and decode.runner.cuda_graphs
                and decode.runner.prefill_chunk_tokens == 512 and cfg.num_blocks == 2112):
            raise SmokeError(f"serve_disagg: not the defaults: {cfg}")
        decode.disagg_router = DisaggregatedRouter(DisaggConfig())
        return decode, prefill, LandingProbe(torch, prefill, decode)

    res = {"card": card, "threshold": DISAGG_LOCAL_MAX, "prompt_lens": PROMPT_LENS,
           "shipped": len(shipped)}

    def logged(tag, row):
        itl = row["itl"]
        log(f"serve_disagg: {tag}: {row['output_tok_per_s']:.1f} tokens/s, inter-token gap "
            f"p50 {itl['p50_ms']:.2f} / p99 {itl['p99_ms']:.2f} / max {itl['max_ms']:.2f} ms, "
            f"{row['stats']['remote_prefills']} remote prefills, "
            f"{row['stats']['remote_fallbacks']} fallbacks"
            + (f", landings {({k: row['landing'][k] for k in ('landings', 'blocks', 'via')})}, "
               f"gap {row['reference_max_logit_gap']:.3f}" if "landing" in row else "")
            + f" ({card})")

    async def go():
        legs = {}
        decode, prefill, probe = pair(params=params)
        # the same weights served by one engine that prefills every prompt
        # single-shot (#3) itself: the yardstick of shipping alone
        single = build(params=params, prefill_chunk_tokens=0)
        router = decode.disagg_router
        ptrs = cache_ptrs(decode.runner)
        device = ColocatedPrefillClient(prefill, BLOCK)
        host = HostPrefillClient(prefill, BLOCK)
        try:
            # (tag, client, #3 launches on the prefill engine, host, frames,
            # DYN_KV_STREAM)
            plan = [("device_bf16", device, len(shipped), False, False, "1"),
                    ("device_bf16", device, len(shipped), False, False, "1"),
                    ("host_monolithic", host, len(shipped), True, False, "0"),
                    ("host_stream", host, one_shot, True, True, "1")]
            for tag, client, n3, on_host, frames, stream in plan:
                decode.remote_prefill_client = client
                os.environ["DYN_KV_STREAM"] = stream
                try:
                    run = await serve_leg(torch, decode, reqs, Context, kernels, probe, prefill)
                finally:
                    os.environ.pop("DYN_KV_STREAM")
                row = check_disagg_leg(torch, f"serve_disagg/{tag}", run, decode, reqs, ptrs,
                                       "paged_decode_attention", L * n3, 0.25, FinishReason,
                                       kernels, on_host, frames)
                legs.setdefault(tag, []).append(row)
                logged(tag, row)
            decode.remote_prefill_client = device
            # the same decode engine serving alone (chunks), and the
            # single-shot engine, once each, in the same run
            for tag, engine, single_shot in (("local_chunks", decode, False),
                                             ("local_single_shot", single, True)):
                decode.disagg_router = None
                run = await serve_leg(torch, engine, reqs, Context, kernels)
                decode.disagg_router = router
                row = check_local_leg(f"serve_disagg/{tag}", run, reqs, L, kernels,
                                      "paged_decode_attention", FinishReason, single_shot)
                legs.setdefault(tag, []).append(row)
                logged(tag, row)
            # the 2000-token TTFT: the decode engine local (four chunks
            # alone at H 4) and disaggregated, and the single-shot engine,
            # in turns
            ways = {"local": (decode, None), "disagg": (decode, router), "single_shot": (single, None)}
            walls = {way: [] for way in ways}
            for way in ("local", "disagg", "single_shot", "single_shot", "disagg",
                        "local") * TTFT_ROUNDS:
                engine, decode.disagg_router = ways[way]
                walls[way].append(await ttft_s(engine, ttft_req, Context))
            device_ms = {}
            for way, (engine, r) in ways.items():
                decode.disagg_router = r
                ms, by_kernel = await profiled_ttft(torch, engine, ttft_req, Context)
                device_ms[way] = {"ms": ms, "top": top_kernels(by_kernel, 1)}
            decode.disagg_router = router
            res["ttft_2000"] = {"wall_ms": {k: [t * 1e3 for t in v] for k, v in walls.items()},
                                "wall_ms_median": {k: statistics.median(v) * 1e3
                                                   for k, v in walls.items()},
                                "device": device_ms}
            res["block_move"] = block_move_times(torch, prefill, decode, n_long)
            res["host_split"] = host_payload_split(torch, prefill, decode, n_long)
        finally:
            for engine in (decode, prefill, single):
                await engine.close()
        del decode, prefill, single, probe, device, host
        gc.collect()
        torch.cuda.empty_cache()
        decode, prefill, probe = pair(params=int8_params, quantize=True, kv_dtype="int8")
        ptrs = cache_ptrs(decode.runner)
        decode.remote_prefill_client = ColocatedPrefillClient(prefill, BLOCK)
        try:
            for _ in range(2):
                run = await serve_leg(torch, decode, reqs, Context, kernels, probe, prefill)
                row = check_disagg_leg(torch, "serve_disagg/device_int8", run, decode, reqs, ptrs,
                                       "paged_decode_attention_int8", L * len(shipped),
                                       INT8_REF_GAP, FinishReason, kernels, False, False)
                legs.setdefault("device_int8", []).append(row)
                logged("device_int8", row)
        finally:
            await decode.close()
            await prefill.close()
        return legs

    legs = asyncio.run(go())
    res["legs"] = {k: [{n: x for n, x in row.items() if n != "launches"} for row in v]
                   for k, v in legs.items()}
    res["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"serve_disagg": res}), flush=True)
    t, bm, hs = res["ttft_2000"], res["block_move"], res["host_split"]
    med, dev = t["wall_ms_median"], t["device"]
    log(f"serve_disagg: 2000-token TTFT disaggregated {med['disagg']:.2f} ms "
        f"(device {dev['disagg']['ms']:.2f}), the decode engine local through chunks "
        f"{med['local']:.2f} ms (device {dev['local']['ms']:.2f}), a single-shot engine "
        f"{med['single_shot']:.2f} ms (device {dev['single_shot']['ms']:.2f}); "
        f"{bm['blocks']} blocks ({bm['kv_bytes'] / 1e6:.1f} MB of K/V): extract "
        f"{bm['extract']['median']:.4f} ms, inject {bm['inject']['median']:.4f} ms, bound "
        f"{bm['bound_ms_each']:.4f} ms each (index_select {bm['index_select']['median']:.4f}, "
        f"index_copy_ {bm['index_copy_']['median']:.4f}); host payload d2h "
        f"{hs['d2h_ms']:.1f} / encode {hs['encode_ms']:.1f} / {hs['checksum']} checksums "
        f"{hs['checksum_ms']:.1f} / decode {hs['decode_ms']:.1f} / h2d {hs['h2d_ms']:.1f} ms; "
        f"tokens/s {', '.join(f'{k} {v[-1]['output_tok_per_s']:.1f}' for k, v in legs.items())}; "
        f"inter-token gap p99 ms "
        f"{', '.join(f'{k} {v[-1]['itl']['p99_ms']:.2f}' for k, v in legs.items())}; "
        f"phase {res['phase_s']:.1f} s ({card})")
    res["launches"] = {k: [row["launches"] for row in v] for k, v in legs.items()
                       if k.startswith(("device", "host"))}
    return res


# ---------------------------------------------------------- serve_offload

OFFLOAD_GB = 4  # DYN_KV_HOST_OFFLOAD_GB: 2048 host blocks of 2 MiB
BLOCK_BYTES = 2 * LLAMA31_8B["num_hidden_layers"] * 8 * BLOCK * 128 * 2  # K + V, bf16
PREFIX = 1024  # the shared prefix: 64 blocks
WAVE_SUFFIXES = [64, 112, 160, 208, 256, 320, 384, 448]
WAVE_OUT = 32
TTFT_SUFFIX = 256
# PCIe Gen5 x16 between the H100 SXM and its host, one direction (NVIDIA's
# data sheet: 128 GB/s both ways)
PCIE_BYTES_PER_S = 64e9
PREEMPT_BLOCKS = 100  # leg (c): 99 usable blocks for four lanes of 35
DISK_HOST_BLOCKS = 16  # leg (e)
OFFLOAD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "serve_offload")


class OnboardProbe:
    """Holds every onboarded block to the pages stored under its hash:
    while a hash is watched, the tier's device store keeps a copy of its
    page on the card, and every ``inject_pages`` of the engine then compares
    each landed block whose hash was stored with that copy, bitwise (K, V
    and an int8 cache's scales). A landed block of a watched hash that was
    never stored fails."""

    def __init__(self, torch, engine) -> None:
        self.torch, self.engine = torch, engine
        self.watch: set = set()
        self.stash: dict = {}
        self.compared = self.mismatched = self.unstored = self.injects = 0
        bm, runner = engine.block_manager, engine.runner
        real_store, real_inject = bm.store_blocks_device, runner.inject_pages

        def store(hashes, *pages):
            for i, h in enumerate(hashes):
                if h in self.watch and h not in self.stash:
                    self.stash[h] = [p[i].clone() for p in pages]
            return real_store(hashes, *pages)

        def inject(ids, *pages):
            out = real_inject(ids, *pages)
            self.injects += 1
            seq = next(s for s in engine.slots if s is not None and s.block_ids[:len(ids)] == ids)
            planes = runner._pages()
            for j, h in enumerate(seq.prefix_hashes[:len(ids)]):
                if h not in self.watch:
                    continue
                if h not in self.stash:
                    self.unstored += 1
                    continue
                self.compared += 1
                same = all(torch.equal(p[:, :, ids[j]].contiguous().view(torch.uint8),
                                       s.view(torch.uint8))
                           for p, s in zip(planes, self.stash[h]))
                self.mismatched += not same
            return out

        bm.store_blocks_device = store
        runner.inject_pages = inject

    def reset(self, watch) -> None:
        self.watch, self.stash = set(watch), {}
        self.compared = self.mismatched = self.unstored = self.injects = 0

    def row(self) -> dict:
        return {"compared": self.compared, "mismatched": self.mismatched,
                "unstored": self.unstored, "injects": self.injects}


class EventLog:
    """An engine's KV events: each Stored event's hash must be BLAKE2b of
    its parent and tokens (the CPU recomputation), and each prompt's hash
    chain must be among the Stored hashes."""

    def __init__(self, engine) -> None:
        self.stored: list = []
        self.removed: list = []
        engine.on_blocks_stored = self.stored.extend
        engine.on_blocks_removed = self.removed.extend

    def take(self, prompts) -> dict:
        from dynamo_tpu_torch.tokens import compute_block_hash, compute_seq_hash_chain

        bad = sum(compute_block_hash(e["parent_hash"], e["tokens"]) != e["block_hash"]
                  for e in self.stored)
        known = {e["block_hash"] for e in self.stored}
        missing = sum(h not in known for p in prompts for h in compute_seq_hash_chain(p, BLOCK))
        row = {"stored": len(self.stored), "removed": len(self.removed), "bad_hash": bad,
               "prompt_blocks_missing": missing}
        self.stored.clear()
        self.removed.clear()
        if bad or missing or not row["stored"]:
            raise SmokeError(f"serve_offload: KV events disagree with the tokens: {row}")
        return row


def tier_errors(tag, engine) -> dict:
    """The leg's failures that the best-effort paths would hide: offload and
    onboard exceptions, local fallbacks and checksum failures must be 0."""
    st, bs = engine.stats, engine.block_manager.stats
    row = {"kv_offload_errors": st.kv_offload_errors, "kv_onboard_errors": st.kv_onboard_errors,
           "remote_fallbacks": st.remote_fallbacks, "integrity_failures": bs.integrity_failures,
           "quarantined": bs.quarantined}
    if any(row.values()):
        raise SmokeError(f"serve_offload/{tag}: {row}")
    return row


def tier_times(torch, engine, n: int = PREFIX // BLOCK, reps: int = 5) -> dict:
    """The host tier's moves of n blocks on the card, medians of ``reps``
    host-clock timings that end in a synchronize: the copies alone into
    and out of pinned and pageable host memory, then the manager's store
    (extract + copies + sync + checksums) and load (checksums + copies +
    sync), each beside the PCIe byte bound; the checksums alone."""
    from dynamo_tpu_torch import integrity

    bm, runner = engine.block_manager, engine.runner
    ids = list(range(1, n + 1))
    pages = runner.extract_pages(ids)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in pages)
    pinned = [torch.empty(p.shape, dtype=p.dtype, pin_memory=True) for p in pages]
    pageable = [torch.empty(p.shape, dtype=p.dtype) for p in pages]
    dev = [p.clone() for p in pages]

    def copies(dsts, srcs):
        for d, s in zip(dsts, srcs):
            d.copy_(s, non_blocking=True)
        torch.cuda.synchronize()

    def med(fn):
        fn()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    out = {"blocks": n, "bytes": nbytes, "bound_ms": nbytes / PCIE_BYTES_PER_S * 1e3,
           "pinned_arena": bm.pinned, "arena_host_bytes": bm.host_bytes,
           "checksum_algo": integrity.ALGO}
    out["d2h_pinned_ms"] = med(lambda: copies(pinned, pages))
    out["h2d_pinned_ms"] = med(lambda: copies(dev, pinned))
    out["d2h_pageable_ms"] = med(lambda: copies(pageable, pages))
    out["h2d_pageable_ms"] = med(lambda: copies(dev, pageable))
    store, load = [], []
    for r in range(reps + 1):
        hashes = [(1 << 62) + r * n + i for i in range(n)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if bm.store_blocks_device(hashes, *runner.extract_pages(ids)) != n:
            raise SmokeError("serve_offload: the timed store did not store every block")
        t1 = time.perf_counter()
        got = bm.load_blocks_device(hashes, runner.device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not all(torch.equal(g.view(torch.uint8), p.view(torch.uint8))
                   for g, p in zip(got, pages)):
            raise SmokeError("serve_offload: a timed load differs from the stored pages")
        if r:  # the first is a warm-up
            store.append((t1 - t0) * 1e3)
            load.append((t2 - t1) * 1e3)
    slots = [bm._host[(1 << 62) + i].index for i in range(n)]
    t0 = time.perf_counter()
    for s in slots:
        bm._slot_sums(s)
    out["checksum_ms"] = (time.perf_counter() - t0) * 1e3
    out["store_ms"], out["load_ms"] = statistics.median(store), statistics.median(load)
    for k in ("d2h_pinned", "h2d_pinned", "d2h_pageable", "h2d_pageable", "store", "load"):
        out[f"{k}_GBps"] = nbytes / (out[f"{k}_ms"] / 1e3) / 1e9
    return out


def offload_engine_check(engine) -> None:
    """build_torch_engine's defaults on the card (H = 4 on CUDA graphs)
    with a pinned host tier."""
    bm = engine.block_manager
    if bm is None or not bm.pinned or engine.config.decode_horizon != HORIZON \
            or not engine.runner.cuda_graphs:
        raise SmokeError(f"serve_offload: not the defaults with a pinned tier: {engine.config}")


def phase_serve_offload(torch, np, card: str, params, int8_params) -> dict:
    """The tiered block manager on the card (see the module docstring,
    phase 15): legs (a) prefix reuse, (b) a mid-generation hit, (c)
    preemption spills, (d) int8 tiers, (e) the disk tier, (f) disaggregated
    with KVBM on the decode engine, (g) POST /clear_kv_blocks and the
    watchdog."""
    import shutil

    from dynamo_tpu_torch.disagg.colocated import ColocatedPrefillClient
    from dynamo_tpu_torch.disagg.router import DisaggConfig, DisaggregatedRouter
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, run_http
    from dynamo_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.ops import kernels
    from dynamo_tpu_torch.protocols.common import (
        Context, FinishReason, PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.tokens import compute_seq_hash_chain

    t_phase = time.perf_counter()
    L = LLAMA31_8B["num_hidden_layers"]
    rng = np.random.default_rng(15)
    n_prefix = PREFIX // BLOCK

    def tokens(n):
        return rng.integers(0, LLAMA31_8B["vocab_size"], n).tolist()

    def greedy(prompt, n):
        return PreprocessedRequest(token_ids=list(prompt), sampling=SamplingOptions(greedy=True),
                                   stop=StopConditions(max_tokens=n))

    def build(gb, disk_dir=None, **kw):
        env = {"DYN_KV_HOST_OFFLOAD_GB": repr(gb)}
        if disk_dir:
            env["DYN_KV_DISK_DIR"] = disk_dir
        os.environ.update(env)
        try:
            engine = build_torch_engine(LLAMA31_8B, device="cuda", max_batch=8,
                                        max_model_len=MAX_MODEL_LEN, seed=0, **kw)
        finally:
            for k in env:
                os.environ.pop(k)
        offload_engine_check(engine)
        return engine

    async def leg(tag, engine, reqs, check=True) -> dict:
        """The requests through ``engine``, counters set to 0 just before,
        read just after; the offloads drained."""
        before = engine.runner.graph_stats()
        s0 = _int_stats(engine.stats)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        outs = await run_requests(engine, reqs, Context)
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        await engine.drain_offloads()
        run = {"outs": outs, "wall": wall, "launches": launches,
               "replayed": replay_launches(kernels, before, engine.runner.graph_stats()),
               "stats": {k: v - s0[k] for k, v in _int_stats(engine.stats).items()}}
        if check:
            check_outputs(f"serve_offload/{tag}", outs, reqs, FinishReason)
        return run

    res = {"card": card, "host_gb": OFFLOAD_GB, "prefix_tokens": PREFIX, "wave": WAVE_SUFFIXES}

    async def go():
        legs = {}
        # (a) prefix reuse, the tier's times, (b) a mid-generation hit and
        # (g) the clear route and the watchdog, on one engine
        engine = build(OFFLOAD_GB, params=params)
        bm, runner = engine.block_manager, engine.runner
        probe, events = OnboardProbe(torch, engine), EventLog(engine)
        ptrs = cache_ptrs(runner)
        res["host_blocks"], res["arena_host_bytes"] = bm.host_blocks, bm.host_bytes
        try:
            prefix = tokens(PREFIX)
            probe.reset(compute_seq_hash_chain(prefix, BLOCK))
            rows = {}
            for wave in (1, 2):
                reqs = [greedy(prefix + tokens(n), WAVE_OUT) for n in WAVE_SUFFIXES]
                run = await leg(f"prefix_wave{wave}", engine, reqs)
                check_horizon_launches(f"serve_offload/wave{wave}", run, L, kernels,
                                       "paged_decode_attention")
                st = run["stats"]
                # wave 1 arrives together: every lookup misses the prefix
                want = 0 if wave == 1 else len(reqs) * n_prefix
                if st["kv_onboarded_blocks"] != want:
                    raise SmokeError(f"serve_offload/wave{wave}: {st['kv_onboarded_blocks']} "
                                     f"blocks onboarded, want {want}")
                if wave == 1 and not all(h in bm for h in probe.watch):
                    raise SmokeError("serve_offload: wave 1 left the prefix out of the tier")
                gap = reference_check(torch, runner, reqs[-1].token_ids, run["outs"][-1][0])
                rows[f"wave{wave}"] = {
                    "stats": st, "launches": run["launches"], "wall_s": run["wall"],
                    "ttft_s": [t for _, _, t in run["outs"]], "reference_max_logit_gap": gap,
                    "events": events.take([r.token_ids for r in reqs])}
            if probe.compared != len(WAVE_SUFFIXES) * n_prefix or probe.mismatched \
                    or probe.unstored:
                raise SmokeError(f"serve_offload: onboarded blocks differ from the stored "
                                 f"ones: {probe.row()}")
            rows["onboarded_vs_stored"] = probe.row()
            # TTFT of a 1280-token prompt: a miss (a fresh prefix: three
            # chunks) against a hit (64 blocks onboarded, one chunk), in turns
            walls = {"miss": [], "hit": []}
            for way in ("miss", "hit", "hit", "miss") * 2:
                p = (prefix if way == "hit" else tokens(PREFIX)) + tokens(TTFT_SUFFIX)
                walls[way].append(await ttft_s(engine, greedy(p, 1), Context) * 1e3)
                await engine.drain_offloads()
            device = {}
            for way in ("miss", "hit"):
                p = (prefix if way == "hit" else tokens(PREFIX)) + tokens(TTFT_SUFFIX)
                ms, by_kernel = await profiled_ttft(torch, engine, greedy(p, 1), Context)
                device[way] = {"ms": ms, "top": top_kernels(by_kernel, 3)}
                await engine.drain_offloads()
            rows["ttft_1280"] = {"wall_ms": walls,
                                 "wall_ms_median": {k: statistics.median(v)
                                                    for k, v in walls.items()},
                                 "device": device}
            rows["tier_times"] = tier_times(torch, engine)
            legs["a_prefix_reuse"] = rows
            # (b) A's 1024-token prompt is onboarded by B while A decodes
            pfx = tokens(PREFIX)
            hashes = compute_seq_hash_chain(pfx, BLOCK)
            probe.reset(hashes)
            s0 = _int_stats(engine.stats)
            a_task = asyncio.ensure_future(run_requests(engine, [greedy(pfx, 160)], Context))
            while not all(h in bm for h in hashes):
                if a_task.done():
                    raise SmokeError("serve_offload/midgen: A ended before its prompt blocks "
                                     "reached the tier")
                await asyncio.sleep(0.002)
            b_req = greedy(pfx + tokens(100), 16)
            b_out = await run_requests(engine, [b_req], Context)
            a_live = not a_task.done()
            a_out = await a_task
            st = {k: v - s0[k] for k, v in _int_stats(engine.stats).items()}
            if not a_live or st["kv_onboarded_blocks"] != n_prefix or probe.compared != n_prefix \
                    or probe.mismatched:
                raise SmokeError(f"serve_offload/midgen: A live {a_live}, {st}, {probe.row()}")
            check_outputs("serve_offload/midgen", a_out + b_out, [greedy(pfx, 160), b_req],
                          FinishReason)
            legs["b_midgen"] = {
                "stats": st, "a_live_at_b_end": a_live, "onboarded_vs_stored": probe.row(),
                "reference_max_logit_gap": reference_check(torch, runner, b_req.token_ids,
                                                           b_out[0][0]),
                "events": events.take([pfx, b_req.token_ids])}
            await engine.drain_offloads()
            # (g) the HTTP server's clear route, then the watchdog
            mdc = ModelDeploymentCard.from_model_dir(write_serve_dir(), "llama-3.1-8b-offload")
            cleared = []
            engine.on_cache_cleared = lambda: cleared.append(1)
            held = bm.stats.host_blocks_used + bm.stats.disk_blocks_used
            svc = await run_http(EngineConfig.static_(engine, mdc), host="127.0.0.1", port=0)
            try:
                status, body = await asyncio.to_thread(http_call, svc.port, "POST",
                                                       "/clear_kv_blocks")
            finally:
                await svc.close()
            body = json.loads(body)
            worker = body["cleared_worker_groups"][0]["workers"][0]
            if status != 200 or body["failed_worker_groups"] or worker["status"] != "cleared" \
                    or worker["offload_blocks_dropped"] != held or cleared != [1] \
                    or bm.lookup_prefix(compute_seq_hash_chain(prefix, BLOCK)) != 0:
                raise SmokeError(f"serve_offload/clear: {status} {body}, cleared {cleared}, "
                                 f"{bm.stats}")
            cold = engine.config.watchdog_cold_s
            first = dict(engine.dispatch_first_s)
            if max(first.values()) >= cold:
                raise SmokeError(f"serve_offload: a first dispatch outran the cold budget "
                                 f"{cold} s: {first}")
            engine.config.watchdog_min_s, engine.config.watchdog_mult = 0.5, 1.0
            name = "decode_multi" if engine.config.decode_horizon > 1 else "decode"
            real = getattr(runner, name)

            def stuck(*a, **k):
                time.sleep(3.0)
                return real(*a, **k)

            setattr(runner, name, stuck)
            tripped = []
            engine.on_watchdog_trip = lambda: tripped.append(time.perf_counter())
            finals = []
            t0 = time.perf_counter()
            for prompt in (tokens(40), tokens(8)):
                async for out in engine.generate(greedy(prompt, 24), Context()):
                    if out.finish_reason is not None:
                        finals.append((out.error or {}).get("code"))
            if finals != ["watchdog_stuck", "worker_unavailable"] or len(tripped) != 1 \
                    or engine.stats.watchdog_trips != 1:
                raise SmokeError(f"serve_offload/watchdog: {finals}, trips {tripped}")
            legs["g_clear_and_watchdog"] = {
                "clear_body": body, "dropped": held, "first_dispatch_s": first,
                "cold_budget_s": cold, "trip_after_s": tripped[0] - t0, "finals": finals}
            if cache_ptrs(runner) != ptrs:
                raise SmokeError("serve_offload: the cache moved under its graphs")
            legs["a_prefix_reuse"]["errors"] = tier_errors("a", engine)
        finally:
            await engine.close()
        del engine, probe, runner, bm
        gc.collect()
        torch.cuda.empty_cache()

        # (c) preemption: three lanes of 300 + 256 tokens (35 blocks each at
        # the end) in 99 blocks, twice: with the mid-generation drain (the
        # victim's blocks are mostly in the tier already) and without it
        # (offload_per_step 0: the victim's blocks spill at preemption)
        rows = []
        for per_step in (4, 0):
            small = build(1, params=params, num_blocks=PREEMPT_BLOCKS)
            small.config.offload_per_step = per_step
            events = EventLog(small)
            try:
                reqs = [greedy(tokens(300), 256) for _ in range(3)]
                run = await leg(f"preempt{per_step}", small, reqs)
                st = run["stats"]
                if not (st["preemptions"] and st["kv_onboarded_blocks"]
                        and (per_step or st["preempt_spills"])):
                    raise SmokeError(f"serve_offload/preempt: no resumption by onboarding "
                                     f"(offload_per_step {per_step}): {st}")
                rows.append({
                    "offload_per_step": per_step, "stats": st, "wall_s": run["wall"],
                    "launches": run["launches"],
                    "reference_max_logit_gap": max(
                        reference_check(torch, small.runner, r.token_ids, o[0])
                        for r, o in zip(reqs, run["outs"])),
                    "events": events.take([r.token_ids for r in reqs]),
                    "errors": tier_errors("c", small)})
                if small.allocator.free_count != PREEMPT_BLOCKS - 1:
                    raise SmokeError("serve_offload/preempt: blocks still held")
            finally:
                await small.close()
            del small
        legs["c_preempt_spill"] = rows

        # (d) int8 weights, an int8-resident cache and fused decode: int8
        # tiers, pages verbatim both ways
        e8 = build(1, params=int8_params, quantize=True, kv_dtype="int8", fused_decode=True)
        probe, events = OnboardProbe(torch, e8), EventLog(e8)
        try:
            p = tokens(600)
            probe.reset(compute_seq_hash_chain(p, BLOCK))
            first = await leg("int8_first", e8, [greedy(p, 32)])
            second = await leg("int8_second", e8, [greedy(p, 32)])
            n = (len(p) - 1) // BLOCK
            if e8.block_manager.wire_codec != "int8" \
                    or second["stats"]["kv_onboarded_blocks"] != n or probe.compared != n \
                    or probe.mismatched:
                raise SmokeError(f"serve_offload/int8: {second['stats']}, {probe.row()}")
            legs["d_int8"] = {
                "stats": [first["stats"], second["stats"]],
                "launches": [first["launches"], second["launches"]],
                "onboarded_vs_stored": probe.row(), "mantissa_steps": 0,
                "reference_max_logit_gap": max(
                    reference_check(torch, e8.runner, p, r["outs"][0][0], bound=INT8_REF_GAP)
                    for r in (first, second)),
                "events": events.take([p]), "errors": tier_errors("d", e8)}
        finally:
            await e8.close()
        del e8, probe

        # (e) a 16-block host tier over a disk tier
        disk = os.path.join(OFFLOAD_DIR, "disk")
        shutil.rmtree(disk, ignore_errors=True)
        ed = build(DISK_HOST_BLOCKS * BLOCK_BYTES / 2**30, disk_dir=disk, params=params)
        probe, events = OnboardProbe(torch, ed), EventLog(ed)
        bm = ed.block_manager
        try:
            p = tokens(PREFIX)
            hashes = compute_seq_hash_chain(p, BLOCK)
            probe.reset(hashes)
            first = await leg("disk_first", ed, [greedy(p, 32)])
            spilled = bm.stats.spilled_g3
            on_disk = sum(h in bm._disk for h in hashes)
            second = await leg("disk_second", ed, [greedy(p + tokens(64), 16)])
            if bm.host_blocks != DISK_HOST_BLOCKS or spilled < n_prefix - DISK_HOST_BLOCKS \
                    or on_disk < n_prefix - DISK_HOST_BLOCKS \
                    or second["stats"]["kv_onboarded_blocks"] != n_prefix \
                    or probe.compared != n_prefix or probe.mismatched:
                raise SmokeError(f"serve_offload/disk: spilled {spilled}, on disk {on_disk}, "
                                 f"{second['stats']}, {probe.row()}, {bm.stats}")
            legs["e_disk"] = {
                "host_blocks": bm.host_blocks, "spilled_g3": spilled,
                "promoted": on_disk, "stats": second["stats"], "manager": vars(bm.stats),
                "onboarded_vs_stored": probe.row(),
                "reference_max_logit_gap": reference_check(torch, ed.runner, p, first["outs"][0][0]),
                "events": events.take([p]), "errors": tier_errors("e", ed)}
        finally:
            await ed.close()
            shutil.rmtree(disk, ignore_errors=True)
        del ed, probe, bm

        # (f) disaggregated: the colocated pair of serve_disagg with the
        # tier on the decode engine; a shipped prompt with a cached prefix
        decode = build(1, params=params)
        prefill = build_torch_engine(LLAMA31_8B, device="cuda", max_batch=8,
                                     max_model_len=MAX_MODEL_LEN, seed=0, params=params)
        decode.disagg_router = DisaggregatedRouter(DisaggConfig())
        shipped = []

        class Recording(ColocatedPrefillClient):
            async def prefill(self, token_ids, **kw):
                resp = await super().prefill(token_ids, **kw)
                shipped.append((kw["cached_blocks"], resp.first_block, resp.num_blocks))
                return resp

        decode.remote_prefill_client = Recording(prefill, BLOCK)
        probe, events = OnboardProbe(torch, decode), EventLog(decode)
        try:
            pfx = tokens(PREFIX)
            probe.reset(compute_seq_hash_chain(pfx, BLOCK))
            reqs = [greedy(pfx + tokens(100), 16), greedy(pfx + tokens(200), 16)]
            runs = [await leg(f"disagg{i}", decode, [r]) for i, r in enumerate(reqs)]
            n2 = -(-len(reqs[1].token_ids) // BLOCK)
            st = runs[1]["stats"]
            if [s[0] for s in shipped] != [0, n_prefix] or shipped[1][1:] != (n_prefix,
                                                                             n2 - n_prefix) \
                    or st["remote_prefills"] != 1 or st["kv_onboarded_blocks"] != n_prefix \
                    or probe.compared != n_prefix or probe.mismatched \
                    or prefill.stats.prefills_served != 2:
                raise SmokeError(f"serve_offload/disagg: shipped {shipped}, {st}, {probe.row()}")
            legs["f_disagg"] = {
                "shipped": shipped, "stats": [r["stats"] for r in runs],
                "launches": [r["launches"] for r in runs], "onboarded_vs_stored": probe.row(),
                "reference_max_logit_gap": max(
                    reference_check(torch, decode.runner, r.token_ids, run["outs"][0][0])
                    for r, run in zip(reqs, runs)),
                "events": events.take([r.token_ids for r in reqs]),
                "errors": tier_errors("f", decode)}
        finally:
            await decode.close()
            await prefill.close()
        return legs

    legs = asyncio.run(go())
    res["legs"] = legs
    res["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"serve_offload": res}, default=str), flush=True)
    a = legs["a_prefix_reuse"]
    t, tt = a["ttft_1280"], a["tier_times"]
    log(f"serve_offload: wave 2 onboarded {a['wave2']['stats']['kv_onboarded_blocks']} blocks, "
        f"all bitwise the stored ones; 1280-token TTFT miss "
        f"{t['wall_ms_median']['miss']:.2f} ms (device {t['device']['miss']['ms']:.2f}), hit "
        f"{t['wall_ms_median']['hit']:.2f} ms (device {t['device']['hit']['ms']:.2f}); "
        f"{tt['blocks']} blocks ({tt['bytes'] / 1e6:.1f} MB): store {tt['store_ms']:.2f} ms "
        f"({tt['store_GBps']:.1f} GB/s), load {tt['load_ms']:.2f} ms ({tt['load_GBps']:.1f} "
        f"GB/s), copies pinned d2h {tt['d2h_pinned_ms']:.2f} / h2d {tt['h2d_pinned_ms']:.2f} ms, "
        f"pageable {tt['d2h_pageable_ms']:.2f} / {tt['h2d_pageable_ms']:.2f} ms, "
        f"{tt['checksum_algo']} checksums {tt['checksum_ms']:.2f} ms, PCIe bound "
        f"{tt['bound_ms']:.2f} ms; arena {res['arena_host_bytes'] / 2**30:.2f} GiB pinned "
        f"{tt['pinned_arena']}; phase {res['phase_s']:.1f} s ({card})")
    for tag, rows in legs.items():
        for row in rows if isinstance(rows, list) else [rows]:
            if tag != "a_prefix_reuse":
                log(f"serve_offload/{tag}: " + json.dumps(
                    {k: v for k, v in row.items() if k not in ("launches", "clear_body", "manager")},
                    default=str))
    return res


def offload_params(torch) -> tuple:
    """The serve phase's bf16 weights (seed 0) and serve_int8's int8 ones,
    made here for a run of serve_offload alone."""
    from dynamo_tpu_torch.engine.torch_engine.factory import _resolve_config
    from dynamo_tpu_torch.engine.torch_engine.weights import load_or_init_params

    cfg, _ = _resolve_config(LLAMA31_8B)
    return tuple(load_or_init_params(None, cfg, seed=0, device="cuda", dtype=torch.bfloat16,
                                     quantize=q) for q in (False, True))


# ------------------------------------------------------------ serve_peer

PEER_BLOCKS = 2112  # each engine's KV pool (two 8B engines share the card)
PEER_HOST_GB = 4  # DYN_KV_HOST_OFFLOAD_GB of each engine: 2048 pinned host blocks of 2 MiB
PEER_PREFIX = 1024  # 64 blocks: 128 MiB of K/V in bf16
PEER_WARM = 160  # the warm-up pull: 10 blocks
PEER_LONG = 3200  # 200 blocks: 400 MiB
PEER_OUT = 16
PEER_LEADER_OUT = 160  # leg (b): the leader still decodes while the follower is routed
PEER_LOAD = 3  # leg (b): requests of 64 blocks the scheduler counts on A
PEER_PREEMPT_BLOCKS = 64  # leg (d): 63 usable blocks for eight lanes growing to 9-11
PEER_PREEMPT_PROMPTS = [40, 56, 72, 48, 64, 80, 44, 60]  # bulk, interactive, ...
PEER_PREEMPT_OUT = 96
HASH_TOKENS = 4096
HASH_REPS = 200


class PullSplit:
    """Times each peer pull's pieces while installed: the serving tier's
    ``load_blocks``, the payload's encode, the puller's decode with verify,
    its ``store_blocks`` and the whole ``fetch_remote_prefix``; what is left
    is the request's hop through the fabric and the reply's pack, send,
    receive and unpack (``send_receive_ms``). Both engines run in this
    process, so the pieces run one after the other on its event loop and
    executor threads."""

    def __init__(self, serving_manager, client) -> None:
        from dynamo_tpu_torch.disagg.protocols import KvBlockPayload

        self.P, self.m_src, self.client = KvBlockPayload, serving_manager, client
        self.rows: list = []
        self._cur: dict = {}
        self._saved = (KvBlockPayload.__dict__["encode"], KvBlockPayload.__dict__["decode"])

    def _timed(self, key, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self._cur[key] = self._cur.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
        return run

    def install(self) -> None:
        enc, dec = self._saved
        self.P.encode = classmethod(self._timed("encode_ms", enc.__func__))
        self.P.decode = self._timed("decode_verify_ms", dec)
        self.m_src.load_blocks = self._timed("load_ms", type(self.m_src).load_blocks.__get__(self.m_src))
        m_dst = self.client.manager
        m_dst.store_blocks = self._timed("store_ms", type(m_dst).store_blocks.__get__(m_dst))
        client, fetch = self.client, type(self.client).fetch_remote_prefix.__get__(self.client)

        async def timed_fetch(seq_hashes, plan=None):
            self._cur = {}
            b0, o0 = client.fetched_bytes, dict(client.pull_outcomes)
            t0 = time.perf_counter()
            n = await fetch(seq_hashes, plan=plan)
            row = dict(self._cur, total_ms=(time.perf_counter() - t0) * 1e3, blocks=n,
                       bytes=client.fetched_bytes - b0, planned=plan is not None,
                       outcomes={k: v - o0.get(k, 0) for k, v in client.pull_outcomes.items()
                                 if v != o0.get(k, 0)})
            row["send_receive_ms"] = row["total_ms"] - sum(
                row.get(k, 0.0) for k in ("load_ms", "encode_ms", "decode_verify_ms", "store_ms"))
            self.rows.append(row)
            return n

        client.fetch_remote_prefix = timed_fetch

    def uninstall(self) -> None:
        self.P.encode, self.P.decode = self._saved
        for obj, name in ((self.m_src, "load_blocks"), (self.client.manager, "store_blocks"),
                          (self.client, "fetch_remote_prefix")):
            obj.__dict__.pop(name, None)

    def take(self, tag: str, outcome: Optional[str] = None) -> dict:
        """The one pull since the last take (fetches that found no peer
        holding the prompt, which count no outcome, are dropped)."""
        self.rows = [r for r in self.rows if r["outcomes"]]
        if len(self.rows) != 1:
            raise SmokeError(f"serve_peer/{tag}: {len(self.rows)} pulls, want 1: {self.rows}")
        row = self.rows.pop()
        if outcome is not None and set(row["outcomes"]) != {outcome}:
            raise SmokeError(f"serve_peer/{tag}: pull outcomes {row['outcomes']}, want "
                             f"only {outcome}")
        return row


def hash_times(rng) -> dict:
    """The native block-hash chain against the Python one over a 4096-token
    prompt (128256-id vocabulary, block 16): microseconds per chain, the
    median of ``HASH_REPS``, and the digests compared."""
    from dynamo_tpu_torch import native
    from dynamo_tpu_torch.tokens import _py_seq_hash_chain, compute_seq_hash_chain

    if not native.native_available():
        raise SmokeError("serve_peer: the native block hash did not load on this machine")
    toks = rng.integers(0, LLAMA31_8B["vocab_size"], HASH_TOKENS).tolist()
    if compute_seq_hash_chain(toks, BLOCK) != _py_seq_hash_chain(toks, BLOCK):
        raise SmokeError("serve_peer: native and Python hash chains differ")

    def med_us(fn):
        ts = []
        for _ in range(HASH_REPS):
            t0 = time.perf_counter()
            fn(toks, BLOCK)
            ts.append((time.perf_counter() - t0) * 1e6)
        return statistics.median(ts)

    nat, py = med_us(compute_seq_hash_chain), med_us(_py_seq_hash_chain)
    return {"tokens": HASH_TOKENS, "native_us": nat, "python_us": py, "speedup": py / nat,
            "library": str(native.library_path())}


def phase_serve_peer(torch, np, card: str, params) -> dict:
    """The peer tier (G4-lite) on the card (see the module docstring, phase
    20): a fabric server process, two engines with pinned host tiers whose
    pulls cross the TCP response plane; (a) undirected pulls, (b) a pull
    directed by the KV router's plan, (c) faults and limits, (d)
    class-aware preemption, (e) the native block hash."""
    from dynamo_tpu_torch.block_manager import PeerBlockClient, PeerBlockService
    from dynamo_tpu_torch.block_manager import peer as peer_mod
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.kv_router.indexer import KvIndexer
    from dynamo_tpu_torch.kv_router.protocols import RouterEvent
    from dynamo_tpu_torch.kv_router.publisher import KvEventPublisher
    from dynamo_tpu_torch.kv_router.scheduler import (
        DefaultWorkerSelector, KvRouterConfig, KvScheduler,
    )
    from dynamo_tpu_torch.protocols.common import (
        Context, FinishReason, PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.testing import faults
    from dynamo_tpu_torch.tokens import compute_seq_hash_chain

    t_phase = time.perf_counter()
    rng = np.random.default_rng(20)

    def tokens(n):
        return rng.integers(0, LLAMA31_8B["vocab_size"], n).tolist()

    def greedy(prompt, n, priority=None):
        extra = {"priority": priority} if priority else {}
        return PreprocessedRequest(token_ids=list(prompt), sampling=SamplingOptions(greedy=True),
                                   stop=StopConditions(max_tokens=n), extra=extra)

    def build(gb, **kw):
        os.environ["DYN_KV_HOST_OFFLOAD_GB"] = repr(gb)
        try:
            engine = build_torch_engine(LLAMA31_8B, device="cuda", max_batch=8,
                                        max_model_len=MAX_MODEL_LEN, seed=0, params=params, **kw)
        finally:
            os.environ.pop("DYN_KV_HOST_OFFLOAD_GB")
        offload_engine_check(engine)
        return engine

    async def serve(tag, engine, reqs, ctxs=None, bound=0.25) -> list:
        """The requests through ``engine``, checked; each greedy stream held
        to the dense reference; the offloads drained."""
        async def one(req, ctx):
            toks, reason, t0, ttft = [], None, time.perf_counter(), None
            async for out in engine.generate(req, ctx):
                if out.token_ids and ttft is None:
                    ttft = time.perf_counter() - t0
                toks.extend(out.token_ids)
                if out.finish_reason is not None:
                    reason = out.finish_reason
                    if out.error:
                        raise SmokeError(f"serve_peer/{tag}: request failed: {out.error}")
            return toks, reason, ttft

        ctxs = ctxs or [Context() for _ in reqs]
        outs = await asyncio.gather(*(one(r, c) for r, c in zip(reqs, ctxs)))
        check_outputs(f"serve_peer/{tag}", outs, reqs, FinishReason)
        for r, (toks, _, _) in zip(reqs, outs):
            reference_check(torch, engine.runner, r.token_ids, toks, bound=bound)
        await engine.drain_offloads()
        return outs

    async def until_held(bm, hashes, tag, timeout=30.0):
        t0 = time.perf_counter()
        while not all(h in bm for h in hashes):
            if time.perf_counter() - t0 > timeout:
                raise SmokeError(f"serve_peer/{tag}: the tier never held the prompt's blocks")
            await asyncio.sleep(0.005)

    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(SERVE_DIR, exist_ok=True)
    fport = free_port()
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    flog = open(os.path.join(SERVE_DIR, "peer_fabric.log"), "w")
    fabric = subprocess.Popen([sys.executable, "-m", "dynamo_tpu_torch.fabric.server", "--host",
                               "127.0.0.1", "--port", str(fport)], cwd=root, env=env, stdout=flog,
                              stderr=subprocess.STDOUT)
    res: dict = {"card": card, "host_gb": PEER_HOST_GB, "blocks": PEER_BLOCKS,
                 "block_bytes": BLOCK_BYTES}

    async def go():
        import socket

        t0 = time.perf_counter()
        while True:  # the server accepts connections
            try:
                socket.create_connection(("127.0.0.1", fport), timeout=1).close()
                break
            except OSError:
                if fabric.poll() is not None or time.perf_counter() - t0 > 30:
                    raise SmokeError("serve_peer: the fabric server did not start")
                await asyncio.sleep(0.1)
        addr = f"127.0.0.1:{fport}"
        drt_a = await DistributedRuntime.from_settings(RuntimeConfig(fabric_addr=addr))
        drt_b = await DistributedRuntime.from_settings(RuntimeConfig(fabric_addr=addr))
        wa, wb = drt_a.primary_lease, drt_b.primary_lease
        a = build(PEER_HOST_GB, num_blocks=PEER_BLOCKS)
        b = build(PEER_HOST_GB, num_blocks=PEER_BLOCKS)
        bm_a, bm_b = a.block_manager, b.block_manager
        svc = PeerBlockService(drt_a, "peer", bm_a, publish_interval_s=0.05, worker_id=wa)
        client = PeerBlockClient(drt_b, "peer", bm_b)
        split = PullSplit(bm_a, client)
        legs: dict = {}
        try:
            await svc.start()
            b.peer_block_client = client
            split.install()
            # warm both engines (graph captures) and the pull path (the
            # endpoint client, the fence watch, the response server)
            for e in (a, b):
                await serve("warm", e, [greedy(tokens(64), 8)])
            split.rows.clear()
            w = tokens(PEER_WARM)
            await serve("warm_a", a, [greedy(w, 8)])
            await until_held(bm_a, compute_seq_hash_chain(w, BLOCK), "warm")
            await asyncio.sleep(0.2)  # the advert publishes
            await serve("warm_pull", b, [greedy(w, 8)])
            legs["warm_pull"] = split.take("warm_pull", "pulled")

            # (a) undirected: A serves the prompt; B pulls it, recomputes
            # it with no client, then hits its own tier
            p = tokens(PEER_PREFIX)
            chain = compute_seq_hash_chain(p, BLOCK)
            a_out = await serve("a_source", a, [greedy(p, PEER_OUT)])
            await until_held(bm_a, chain, "a")
            await asyncio.sleep(0.2)
            pages_a = bm_a.load_blocks_device(chain, a.runner.device)
            probe = OnboardProbe(torch, b)
            probe.reset(chain)
            probe.stash = {h: [t[i].clone() for t in pages_a] for i, h in enumerate(chain)}
            s0 = _int_stats(b.stats)
            t_on = []
            onboard = b._onboard_prefix

            async def timed_onboard(seq):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                n = await onboard(seq)
                torch.cuda.synchronize()
                t_on.append((time.perf_counter() - t1) * 1e3)
                return n

            b._onboard_prefix = timed_onboard
            pulled = await serve("a_pulled", b, [greedy(p, PEER_OUT)])
            del b._onboard_prefix
            st = {k: v - s0[k] for k, v in _int_stats(b.stats).items()}
            pull = split.take("a_pulled", "pulled")
            pages_b = bm_b.load_blocks_device(chain, b.runner.device)
            same_tier = all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                            for x, y in zip(pages_a, pages_b))
            want_on = len(chain)  # every block onboarded; the last one's tokens are prefilled again
            if pull["blocks"] != len(chain) or not same_tier or probe.compared != want_on \
                    or probe.mismatched or probe.unstored or st["kv_onboarded_blocks"] != want_on:
                raise SmokeError(f"serve_peer/a: pulled {pull}, tier pages equal {same_tier}, "
                                 f"{probe.row()}, {st}")
            landed = probe.row()
            probe.reset(())
            b.peer_block_client = None
            bm_b.clear()
            recomputed = await serve("a_recompute", b, [greedy(p, PEER_OUT)])
            if any(r["outcomes"] for r in split.rows):
                raise SmokeError("serve_peer/a: the client pulled with no client set")
            await until_held(bm_b, chain, "a_recompute")
            s0 = _int_stats(b.stats)
            hit = await serve("a_local_hit", b, [greedy(p, PEER_OUT)])
            if _int_stats(b.stats)["kv_onboarded_blocks"] - s0["kv_onboarded_blocks"] != want_on:
                raise SmokeError("serve_peer/a: the local hit did not onboard the prefix")
            b.peer_block_client = client
            legs["a_undirected"] = {
                "prompt_tokens": len(p), "pull": pull, "onboard_ms": t_on,
                "onboarded_vs_source_tier": landed, "tier_pages_equal": same_tier,
                "ttft_ms": {"source": a_out[0][2] * 1e3, "pulled": pulled[0][2] * 1e3,
                            "recomputed": recomputed[0][2] * 1e3, "local_hit": hit[0][2] * 1e3},
                "tokens_equal_source": {"pulled": pulled[0][0] == a_out[0][0],
                                        "recomputed": recomputed[0][0] == a_out[0][0],
                                        "local_hit": hit[0][0] == a_out[0][0]},
                "stats": st}

            # (b) directed: the KV router's scheduler over both engines'
            # events routes a follower to B through the load term (A counts
            # three 64-block requests more) and plans a pull from A
            indexer = KvIndexer(BLOCK, expiration_duration=600.0)

            class Events(KvEventPublisher):
                def _publish(self, event):
                    indexer.apply_event(RouterEvent(self.worker_id, event))

            for e, wid in ((a, wa), (b, wb)):
                pub = Events(None, wid)
                e.on_blocks_stored, e.on_blocks_removed = pub.on_blocks_stored, pub.on_blocks_removed
            cfg = KvRouterConfig(router_temperature=0.0, prefix_pull=True)
            sched = KvScheduler(BLOCK, DefaultWorkerSelector(cfg), config=cfg)
            sched.update_workers([wa, wb])
            for i in range(PEER_LOAD):
                sched.sequences.add_request_chain(wa, compute_seq_hash_chain(tokens(PEER_PREFIX),
                                                                             BLOCK), 0, f"load{i}")
            p2 = tokens(PEER_PREFIX)
            chain2 = compute_seq_hash_chain(p2, BLOCK)
            leader = asyncio.ensure_future(serve("b_leader", a, [greedy(p2 + tokens(64),
                                                                         PEER_LEADER_OUT)]))
            await until_held(bm_a, chain2, "b_leader")
            follower = p2 + tokens(64)
            overlap = indexer.find_matches_for_request(follower)
            if overlap.scores.get(wa, 0) < len(chain2):
                raise SmokeError(f"serve_peer/b: the index holds {overlap.scores} of A's prefix")
            await asyncio.sleep(0.2)  # A's advert names the prefix
            route = sched.schedule(follower, overlap, request_id="follower")
            plan = route.pull_plan
            if route.worker_id != wb or not plan or plan["src"] != wa \
                    or plan["blocks"] != len(chain2) or sched.pull_stats["plans"] != 1:
                raise SmokeError(f"serve_peer/b: routed to {route.worker_id:x} (B {wb:x}) with "
                                 f"plan {plan and {k: plan[k] for k in ('src', 'blocks', 'avoid')}}, "
                                 f"{sched.pull_stats}")
            ctx = Context()
            ctx.decisions().pull_plan = plan
            directed = await serve("b_follower", b, [greedy(follower, PEER_OUT)], [ctx])
            await leader
            row = split.take("b_directed", "pulled")
            if not row["planned"] or row["blocks"] != len(chain2) \
                    or any(h not in bm_b._fleet_heat for h in chain2):
                raise SmokeError(f"serve_peer/b: {row}, fleet heat noted "
                                 f"{sum(h in bm_b._fleet_heat for h in chain2)}")
            for e in (a, b):
                e.on_blocks_stored = e.on_blocks_removed = None
            legs["b_directed"] = {
                "routed_to_b": True, "plan": {k: plan[k] for k in ("blocks", "avoid")},
                "plan_src_is_a": True, "freq_head": plan.get("freq", [])[:4],
                "pull_stats": dict(sched.pull_stats), "pull": row,
                "ttft_ms": directed[0][2] * 1e3}

            # (c) faults and limits: corrupt_kv=bits on A's replies (the
            # injector seen by the peer module alone: both engines' tiers
            # run in this process), the int8 wire, ~200 blocks
            p3 = tokens(PEER_PREFIX)
            src3 = await serve("c_source", a, [greedy(p3, PEER_OUT)])
            await until_held(bm_a, compute_seq_hash_chain(p3, BLOCK), "c")
            await asyncio.sleep(0.2)
            inj = faults.FaultInjector(faults.FaultSpec.parse("corrupt_kv=bits"))
            peer_mod.faults = types.SimpleNamespace(active=lambda: True, get_injector=lambda: inj)
            try:
                corrupt = await serve("c_corrupt", b, [greedy(p3, PEER_OUT)])
            finally:
                peer_mod.faults = faults
            crow = split.take("c_corrupt", "fallback_integrity")
            if corrupt[0][0] != src3[0][0]:
                raise SmokeError("serve_peer/c: the stream after a refused pull differs from the "
                                 "source's")
            p4 = tokens(PEER_PREFIX)
            src4 = await serve("c_source_int8", a, [greedy(p4, PEER_OUT)])
            await until_held(bm_a, compute_seq_hash_chain(p4, BLOCK), "c_int8")
            await asyncio.sleep(0.2)
            os.environ["DYN_KV_WIRE"] = "int8"
            try:
                int8 = await serve("c_int8", b, [greedy(p4, PEER_OUT)], bound=INT8_REF_GAP)
            finally:
                os.environ.pop("DYN_KV_WIRE")
            irow = split.take("c_int8", "pulled")
            p5 = tokens(PEER_LONG)
            src5 = await serve("c_source_long", a, [greedy(p5, PEER_OUT)])
            await until_held(bm_a, compute_seq_hash_chain(p5, BLOCK), "c_long", timeout=60)
            await asyncio.sleep(0.2)
            long = await serve("c_long", b, [greedy(p5, PEER_OUT)])
            lrow = split.take("c_long")
            if set(lrow["outcomes"]) - {"pulled", "fallback_timeout"}:
                raise SmokeError(f"serve_peer/c_long: {lrow}")
            legs["c_faults_limits"] = {
                "corrupt": {"pull": crow, "ttft_ms": corrupt[0][2] * 1e3,
                            "source_ttft_ms": src3[0][2] * 1e3, "stream_equal_source": True,
                            "faults_fired": inj.fired},
                "int8_wire": {"pull": irow, "ttft_ms": int8[0][2] * 1e3,
                              "source_ttft_ms": src4[0][2] * 1e3,
                              "bytes_vs_bf16": irow["bytes"] / pull["bytes"]},
                "long": {"prompt_tokens": len(p5), "pull": lrow, "ttft_ms": long[0][2] * 1e3,
                         "source_ttft_ms": src5[0][2] * 1e3,
                         "timeout_s": float(os.environ.get("DYN_PULL_TIMEOUT_S", "5.0"))}}
            legs["errors"] = {"a": tier_errors("a", a), "b": tier_errors("b", b)}
            legs["pull_outcomes_b"] = dict(b.stats.kv_pull_outcomes)
            legs["capped_replies"] = svc.capped_replies
        finally:
            split.uninstall()
            await svc.close()
            await a.close()
            await b.close()
            await drt_a.close()
            await drt_b.close()
        del a, b, bm_a, bm_b
        gc.collect()
        torch.cuda.empty_cache()

        # (d) class-aware preemption: four bulk and four interactive lanes
        # in 63 usable blocks
        c = build(1, num_blocks=PEER_PREEMPT_BLOCKS)
        try:
            reqs = [greedy(tokens(n), PEER_PREEMPT_OUT, "bulk" if i % 2 == 0 else "interactive")
                    for i, n in enumerate(PEER_PREEMPT_PROMPTS)]
            s0 = _int_stats(c.stats)
            outs = await serve("d_preempt", c, reqs)
            st = {k: v - s0[k] for k, v in _int_stats(c.stats).items()}
            by_class = dict(c.stats.preemptions_by_class)
            if not by_class.get("bulk") or by_class.get("interactive") or by_class.get("standard"):
                raise SmokeError(f"serve_peer/d: preemptions by class {by_class}")
            if c.allocator.free_count != PEER_PREEMPT_BLOCKS - 1:
                raise SmokeError("serve_peer/d: blocks still held")
            legs["d_preempt"] = {
                "preemptions_by_class": by_class, "preempt_spills": st["preempt_spills"],
                "onboarded": st["kv_onboarded_blocks"],
                "ttft_ms": {r.extra["priority"]: [] for r in reqs},
                "errors": tier_errors("d", c)}
            for r, o in zip(reqs, outs):
                legs["d_preempt"]["ttft_ms"][r.extra["priority"]].append(o[2] * 1e3)
        finally:
            await c.close()
        return legs

    try:
        legs = asyncio.run(go())
    finally:
        fabric.terminate()
        try:
            fabric.wait(10)
        except subprocess.TimeoutExpired:
            fabric.kill()
            fabric.wait()
        flog.close()
    legs["e_native_hash"] = hash_times(rng)
    res["legs"] = legs
    res["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"serve_peer": res}, default=str), flush=True)
    a, pull = legs["a_undirected"], legs["a_undirected"]["pull"]
    log(f"serve_peer: {pull['blocks']} blocks ({pull['bytes'] / 2**20:.1f} MiB) pulled in "
        f"{pull['total_ms']:.1f} ms: load {pull.get('load_ms', 0):.1f}, encode "
        f"{pull.get('encode_ms', 0):.1f}, send+receive {pull['send_receive_ms']:.1f}, decode+verify "
        f"{pull.get('decode_verify_ms', 0):.1f}, store {pull.get('store_ms', 0):.1f} ms; onboard "
        f"{a['onboard_ms']} ms; TTFT pulled {a['ttft_ms']['pulled']:.1f} / recomputed "
        f"{a['ttft_ms']['recomputed']:.1f} / local hit {a['ttft_ms']['local_hit']:.1f} ms "
        f"(source {a['ttft_ms']['source']:.1f}); phase {res['phase_s']:.1f} s ({card})")
    for tag in ("b_directed", "c_faults_limits", "d_preempt", "e_native_hash"):
        log(f"serve_peer/{tag}: " + json.dumps(legs[tag], default=str))
    return res


def peer_params(torch) -> dict:
    """The serve phase's bf16 weights (seed 0), made here for a run of
    serve_peer alone."""
    from dynamo_tpu_torch.engine.torch_engine.factory import _resolve_config
    from dynamo_tpu_torch.engine.torch_engine.weights import load_or_init_params

    cfg, _ = _resolve_config(LLAMA31_8B)
    return load_or_init_params(None, cfg, seed=0, device="cuda", dtype=torch.bfloat16)


# ------------------------------------------------------------ serve_moe

# mistralai/Mixtral-8x7B-v0.1's published config.json; the phase serves
# MOE_LAYERS of its 32 layers: all 32 hold 93.4 GB of bf16 weights (90.2 GB
# of experts, never quantized), more than one card's 80 GB
MIXTRAL_8X7B = {
    "architectures": ["MixtralForCausalLM"],
    "attention_dropout": 0.0,
    "bos_token_id": 1,
    "eos_token_id": 2,
    "hidden_act": "silu",
    "hidden_size": 4096,
    "initializer_range": 0.02,
    "intermediate_size": 14336,
    "max_position_embeddings": 32768,
    "model_type": "mixtral",
    "num_attention_heads": 32,
    "num_experts_per_tok": 2,
    "num_hidden_layers": 32,
    "num_key_value_heads": 8,
    "num_local_experts": 8,
    "output_router_logits": False,
    "rms_norm_eps": 1e-05,
    "rope_theta": 1000000.0,
    "router_aux_loss_coef": 0.02,
    "sliding_window": None,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
    "vocab_size": 32000,
}
MOE_LAYERS = 16
MOE_KERNEL = "grouped_swiglu_ffn"
# the dense reference attends the cache-free plain way, the engine through
# the paged kernels: a last-bit difference can flip a token's routing at a
# near-tie of its router logits, which moves its logits more than bf16 noise
# does (INT8_REF_GAP's bound, not serve's 0.25)
MOE_REF_GAP = 0.5
# rows per expert (E 8) the kernel is held to its plain version at: decode
# B = 1 and B = 8, verify B = 8 x S = 4, one 512-token chunk; every row on
# one expert; experts left empty
MOE_PARITY = {
    "R2": [0, 1, 0, 0, 0, 1, 0, 0],
    "R16": [2, 3, 1, 0, 4, 2, 2, 2],
    "R64": [8, 12, 4, 9, 7, 8, 6, 10],
    "R1024": [130, 120, 140, 100, 134, 150, 110, 140],
    "one_expert": [0, 0, 0, 16, 0, 0, 0, 0],
    "empty_experts": [0, 0, 30, 1, 0, 33, 0, 0],
}


def grouped_inputs(torch, counts, D: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = torch.randn(sum(counts), D, device="cuda", generator=g).bfloat16()
    offsets = torch.tensor([0] + [int(c) for c in itertools.accumulate(counts)],
                           dtype=torch.int32, device="cuda")
    return xs, offsets


def grouped_bound(counts, D: int, F: int) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, bytes, flops) of one grouped FFN: the
    weights of the experts that received rows (read once), the rows read,
    the output written, the offsets; 3 products of 2 R D F flops."""
    R = sum(counts)
    nbytes = sum(1 for c in counts if c) * 3 * D * F * 2 + 2 * R * D * 2 + 4 * (len(counts) + 1)
    flops = 2.0 * R * D * F * 3
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations"), nbytes, flops


def grouped_library(torch, xs, offsets, wg, wu, wd):
    """One PyTorch grouped product per projection, where the card's torch
    has one (torch._grouped_mm, CUTLASS grouped GEMMs; SwiGLU between them),
    else None."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None
    ends = offsets[1:]

    def call():
        gate = fn(xs, wg, offs=ends)
        up = fn(xs, wu, offs=ends)
        return fn(torch.nn.functional.silu(gate) * up, wd, offs=ends)

    try:
        call()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as e:  # not built for this card / these shapes
        log(f"serve_moe: torch._grouped_mm refused the grouped FFN ({type(e).__name__}: {e})")
        return None
    return call


def moe_kernel_row(torch, flush, layer, counts, seed: int) -> dict:
    """The grouped kernel at one routing, CUDA-event timed beside its bound,
    its plain version and the library's grouped products (or, without them,
    the per-expert cuBLAS loop, which is the plain version)."""
    from dynamo_tpu_torch.ops import moe
    from dynamo_tpu_torch.ops.cuda_moe import grouped_swiglu_ffn_cuda

    wg, wu, wd = layer["wg"], layer["wu"], layer["wd"]
    D, F = wg.shape[1], wg.shape[2]
    xs, off = grouped_inputs(torch, counts, D, seed)
    bound, by, nbytes, flops = grouped_bound(counts, D, F)
    row = {"rows": sum(counts), "experts_routed": sum(1 for c in counts if c),
           "ms": time_ms(torch, lambda: grouped_swiglu_ffn_cuda(xs, off, wg, wu, wd), flush=flush),
           "plain_ms": time_ms(torch, lambda: moe.grouped_ffn_plain(xs, off, wg, wu, wd), reps=5,
                               flush=flush),
           "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": flops}
    lib = grouped_library(torch, xs, off, wg, wu, wd)
    if lib is not None:
        row["library_ms"] = time_ms(torch, lib, flush=flush)
        row["library"] = "torch._grouped_mm x 3 + silu * up"
    else:
        row["library_ms"] = row["plain_ms"]
        row["library"] = "per-expert cuBLAS loop (grouped_ffn_plain): no torch._grouped_mm"
    return row


def step_routing(torch, np, runner) -> list:
    """Rows per expert of layer 0 at the B=8 step: its router over the
    normed hidden states of 8 random tokens' embeddings."""
    from dynamo_tpu_torch.ops import moe
    from dynamo_tpu_torch.ops.basics import rms_norm

    cfg, p = runner.config, runner.params
    toks = torch.tensor(np.random.default_rng(12).integers(0, cfg.vocab_size, 8), device="cuda")
    h = rms_norm(p["embed"][toks], p["layers"][0]["mlp_norm"], cfg.rms_eps)
    idx, _ = moe._router(h, p["layers"][0]["router"], cfg.num_experts_per_tok)
    _, _, offsets = moe.expert_order(idx.reshape(-1), cfg.num_experts)
    return np.diff(offsets.cpu().numpy()).tolist()


def moe_oracle_check(torch, np, runner) -> float:
    """moe_ffn_dropless at the B=8 step's shape on the card against an f32
    loop over tokens and their top-2 experts that rounds where the kernel
    rounds (gate, up, silu(gate), act and each expert's output to bf16),
    with the port's routing (the same f32 router product); held to
    GEMV_TOL. Returns the largest |difference|."""
    from dynamo_tpu_torch.ops import moe

    cfg, layer = runner.config, runner.params["layers"][0]
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(8, cfg.hidden_size, device="cuda", generator=g).bfloat16()
    got = moe.moe_ffn_dropless(x, layer["router"], layer["wg"], layer["wu"], layer["wd"],
                               cfg.num_experts_per_tok)
    idx, w = moe._router(x, layer["router"], cfg.num_experts_per_tok)
    want = torch.zeros(x.shape, device="cuda")
    for t in range(x.shape[0]):
        for e, we in zip(idx[t].tolist(), w[t]):
            gate = (x[t].float() @ layer["wg"][e].float()).bfloat16()
            up = (x[t].float() @ layer["wu"][e].float()).bfloat16()
            act = (torch.nn.functional.silu(gate) * up).float()
            want[t] += we * (act @ layer["wd"][e].float()).bfloat16().float()
    return compare(torch, "serve_moe/dropless_vs_f32_oracle", got, want.bfloat16(), GEMV_TOL)


def moe_step_times(torch, np, runner) -> dict:
    """The graphed decode step (model + sampling + fetch) at context 1024,
    B = 8 and B = 1: wall (host clock around work ending in the fetch),
    device time and the grouped kernel's share of it (torch.profiler), and
    the whole MoE layer's share (moe_ffn_dropless's device time at the
    step's rows under the profiler, x layers)."""
    from dynamo_tpu_torch.ops import moe
    from dynamo_tpu_torch.ops.basics import rms_norm

    cfg, L = runner.config, runner.config.num_layers
    layer = runner.params["layers"][0]
    out = {}
    for B in (8, 1):
        toks, pos, tables, slots = step_case(np, runner, B=B)
        z, o, kz = np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int64)

        def step():
            return runner.fetch_sample(runner.decode(toks, pos, tables, slots, z, o, kz))

        for _ in range(3):  # the first captures this B's graph
            step()
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            step()
            walls.append((time.perf_counter() - t0) * 1e3)
        dev_ms, kern = profile_calls(torch, step, calls=3)
        grouped = sum(us for k, (us, _) in kern.items() if "grouped_ffn_kernel" in k) / 3 / 1e3
        g = torch.Generator(device="cuda").manual_seed(30 + B)
        h = rms_norm(torch.randn(B, cfg.hidden_size, device="cuda", generator=g).bfloat16(),
                     layer["mlp_norm"], cfg.rms_eps)
        layer_ms = device_ms_per_call(torch, lambda: moe.moe_ffn_dropless(
            h, layer["router"], layer["wg"], layer["wu"], layer["wd"], cfg.num_experts_per_tok))
        out[f"B{B}"] = {"wall_ms": statistics.median(walls), "wall_min_ms": min(walls),
                        "device_ms": dev_ms, "grouped_kernel_ms": grouped,
                        "grouped_kernel_share": grouped / dev_ms,
                        "moe_layer_device_ms": layer_ms,
                        "moe_layers_share": L * layer_ms / dev_ms}
    return out


EP = 2  # the EP leg's ranks: two gloo ranks on cuda:0
EP_LAYERS = 4  # Mixtral-8x7B's width at 4 layers: ~12 GB of bf16, half the experts a rank
EP_BLOCKS = 1024


def serve_moe_ep(torch, np, card: str) -> dict:
    """Expert parallelism: Mixtral-8x7B's width at EP_LAYERS layers on one
    card (the grouped path), then an ep = 2 grid (two gloo ranks on cuda:0,
    4 experts each) on the same seeded weights: the decode step's logits
    after a packed prefill (512 tokens: the all-to-all form; B = 3: the
    psum form) within TP_LOGIT_TOL of one card's, then serve's four
    requests (every rank's counters set to 0 just before, read just after:
    kernel g launched on every rank, #1 once a layer per decode or mixed
    step)."""
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.protocols.common import (
        Context, FinishReason, PreprocessedRequest, SamplingOptions, StopConditions,
    )

    t0 = time.perf_counter()
    conf = dict(MIXTRAL_8X7B, num_hidden_layers=EP_LAYERS)
    kw = dict(max_batch=8, max_model_len=MAX_MODEL_LEN, seed=0, num_blocks=EP_BLOCKS, **EAGER)
    every = make_requests(np, PreprocessedRequest, SamplingOptions, StopConditions,
                          vocab=conf["vocab_size"], eos_id=MIXTRAL_8X7B["eos_token_id"])
    reqs = [every[i] for i in TP_REQUESTS]
    rng = np.random.default_rng(3)
    probe = [rng.integers(0, conf["vocab_size"], n).tolist() for n in (16, 100, 300)]
    one = build_torch_engine(conf, device="cuda", **kw)
    want = first_step_logits(torch, np, one.runner, probe)
    one_out = asyncio.run(run_requests(one, reqs, Context))
    asyncio.run(one.close())
    del one
    gc.collect()
    torch.cuda.empty_cache()
    engine = build_torch_engine(conf, device="cuda", expert_parallel_size=EP, tp_backend="gloo",
                                tp_devices=["cuda:0"] * EP, **kw)
    runner = engine.runner
    if runner.params["layers"][0]["wg"].shape[0] != MIXTRAL_8X7B["num_local_experts"] // EP:
        raise SmokeError(f"serve_moe/ep: a rank holds {runner.params['layers'][0]['wg'].shape}")
    got = first_step_logits(torch, np, runner, probe)
    worst = rel_logit_err(torch, got, want)
    if worst > TP_LOGIT_TOL:
        raise SmokeError(f"serve_moe/ep: first-step logits {worst:.4f} of the row's max apart "
                         f"from one card's (tol {TP_LOGIT_TOL})")
    runner.rank_stats(reset=True)
    t1 = time.perf_counter()
    out = asyncio.run(run_requests(engine, reqs, Context))
    wall = time.perf_counter() - t1
    stats = stats_dict(engine.stats)
    ranks = runner.rank_stats()
    asyncio.run(engine.close())
    if [p.exitcode for p in runner._processes] != [0] * (EP - 1):
        raise SmokeError(f"serve_moe/ep: followers ended {[p.exitcode for p in runner._processes]}")
    for i, ((toks, reason, _), req) in enumerate(zip(out, reqs)):
        if reason is not FinishReason.LENGTH or len(toks) != req.stop.max_tokens:
            raise SmokeError(f"serve_moe/ep request {i}: {len(toks)} tokens, reason {reason}")
    steps = stats["decode_steps"] + stats["mixed_steps"]
    for r, st in enumerate(ranks):
        lc = st["launches"]
        moved = {k for k, v in lc.items() if v}
        if (lc[MOE_KERNEL] <= 0 or lc["paged_decode_attention"] != EP_LAYERS * steps
                or moved != {MOE_KERNEL, "paged_decode_attention"}):
            raise SmokeError(f"serve_moe/ep rank {r}: launches {lc} ({EP_LAYERS} x {steps} "
                             f"decode / mixed steps)")
    n_tok = sum(len(t) for t, _, _ in one_out)
    agree = sum(a == b for (x, _, _), (y, _, _) in zip(one_out, out) for a, b in zip(x, y)) / n_tok
    res = {
        "layers": EP_LAYERS, "ep": EP, "first_step_max_rel_err": worst,
        "first_step_argmax_same": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
        "requests": len(reqs), "stats": stats, "wall_s": wall, "greedy_token_agreement": agree,
        "rank_launches": [st["launches"] for st in ranks],
        "rank_peak_mem_bytes": [st.get("peak_mem_bytes") for st in ranks],
        "rank_staged_bytes": [st["staged_bytes"] for st in ranks],
        "rank_collective_s": [st["collective_s"] for st in ranks],
        "leg_s": time.perf_counter() - t0,
    }
    log(f"serve_moe/ep: ep=2 first-step logits within {worst:.4f} of one card's row max; "
        f"{len(reqs)} requests in {wall:.2f} s ({stats['packed_prefills']} packed prefills, "
        f"{stats['chunk_steps']} chunks, {stats['mixed_steps']} mixed + {stats['decode_steps']} "
        f"decode steps); per rank kernel g {[st['launches'][MOE_KERNEL] for st in ranks]}, #1 "
        f"{[st['launches']['paged_decode_attention'] for st in ranks]}; collectives "
        f"{[round(st['collective_s'], 2) for st in ranks]} s, staged "
        f"{[st['staged_bytes'] for st in ranks]} B; greedy tokens agreeing with one card "
        f"{agree:.3f}; peak memory per rank "
        f"{[round((m or 0) / 1e9, 2) for m in res['rank_peak_mem_bytes']]} GB ({card})")
    print(json.dumps({"serve_moe_ep": res, "card": card}), flush=True)
    return res


def phase_serve_moe(torch, np, card: str) -> dict:
    """Mixtral-8x7B's width at MOE_LAYERS layers through build_torch_engine's
    defaults on a card (see the module docstring, phase 13)."""
    from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.ops import kernels, moe
    from dynamo_tpu_torch.ops.cuda_moe import grouped_swiglu_ffn_cuda
    from dynamo_tpu_torch.protocols.common import (
        Context, FinishReason, PreprocessedRequest, SamplingOptions, StopConditions,
    )

    t_phase = time.perf_counter()
    mem_before = torch.cuda.memory_allocated()
    conf = dict(MIXTRAL_8X7B, num_hidden_layers=MOE_LAYERS)
    engine = build_torch_engine(conf, device="cuda", max_batch=8, max_model_len=MAX_MODEL_LEN,
                                seed=0)
    runner = engine.runner
    cfg0, cfg = engine.config, runner.config
    L = cfg.num_layers
    if not (cfg0.decode_horizon == HORIZON and runner.cuda_graphs and cfg0.mixed_step
            and runner.prefill_chunk_tokens == 512 and cfg.num_experts == 8 and L == MOE_LAYERS):
        raise SmokeError(f"serve_moe: defaults H {cfg0.decode_horizon}, graphs "
                         f"{runner.cuda_graphs}, chunk {runner.prefill_chunk_tokens}, experts "
                         f"{cfg.num_experts}, layers {L}")
    torch.cuda.synchronize()
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(runner.params))
    experts = sum(runner.params["layers"][i][k].numel() * 2 for i in range(L)
                  for k in ("wg", "wu", "wd"))
    log(f"serve_moe: engine built in {time.perf_counter() - t_phase:.1f} s; weights "
        f"{wbytes / 1e9:.2f} GB ({experts / 1e9:.2f} GB of experts), KV pool "
        f"{runner.num_blocks} blocks ({runner.kv_cache_bytes / 1e9:.2f} GB)")

    # 1. the kernel against its plain version at Mixtral's width (layer 0's
    # experts), then the dropless layer against an f32 per-token oracle
    layer = runner.params["layers"][0]
    errs = {}
    for i, (name, counts) in enumerate(MOE_PARITY.items()):
        xs, off = grouped_inputs(torch, counts, cfg.hidden_size, seed=40 + i)
        errs[name] = compare(torch, f"{MOE_KERNEL}/{name}",
                             grouped_swiglu_ffn_cuda(xs, off, layer["wg"], layer["wu"], layer["wd"]),
                             moe.grouped_ffn_plain(xs, off, layer["wg"], layer["wu"], layer["wd"]),
                             GEMV_TOL)
    oracle_err = moe_oracle_check(torch, np, runner)
    log(f"serve_moe: {MOE_KERNEL} vs plain {errs}; dropless vs f32 oracle {oracle_err:.5f}")

    # 2. serve's 8 requests (ids below 32000) twice through the defaults
    reqs = make_requests(np, PreprocessedRequest, SamplingOptions, StopConditions,
                         vocab=cfg.vocab_size, eos_id=MIXTRAL_8X7B["eos_token_id"])
    mem0 = torch.cuda.memory_allocated()
    g4 = serve_runs(torch, engine, [("serve", reqs), ("serve", reqs)], Context, kernels)
    mem_graphs = torch.cuda.memory_allocated() - mem0
    for run in g4["serve"]:
        check_outputs("serve_moe", run["outs"], reqs, FinishReason, vocab=cfg.vocab_size)
        st = run["stats"]
        eager = L * (st["packed_prefills"] + st["chunk_steps"] + st["prefills"])
        check_horizon_launches("serve_moe", run, L, kernels, "paged_decode_attention",
                               eager={MOE_KERNEL: eager})
        bodies = st["decode_steps"] + st["horizon_steps"] + st["verify_chained_steps"]
        if run["replayed"][MOE_KERNEL] != L * bodies or run["launches"][MOE_KERNEL] <= 0:
            raise SmokeError(f"serve_moe: {MOE_KERNEL} replayed {run['replayed'][MOE_KERNEL]} "
                             f"!= {L} x {bodies} step bodies")
    first, warm = g4["serve"]
    if [t for t, _, _ in warm["outs"]] != [t for t, _, _ in first["outs"]]:
        raise SmokeError("serve_moe: the repeated run gave other tokens")
    gap = reference_check(torch, runner, reqs[0].token_ids, first["outs"][0][0], bound=MOE_REF_GAP)
    log(f"serve_moe: served at {time.perf_counter() - t_phase:.1f} s; reference gap {gap:.3f}")

    # 3. every graph's replay against its eager call, bitwise
    bitwise = replay_vs_eager(torch, np, runner, "moe", eos_id=MIXTRAL_8X7B["eos_token_id"])

    # 4. times: the graphed step at B = 8 and 1, the kernel at the step's
    # routing (B = 8: layer 0's router over 8 tokens; B = 1: its first
    # token's two experts) and at a 512-token chunk's
    steps = moe_step_times(torch, np, runner)
    flush = make_flush(torch)
    counts8 = step_routing(torch, np, runner)
    counts1 = [0] * cfg.num_experts
    for e in (i for i, c in enumerate(counts8) if c):
        if sum(counts1) < cfg.num_experts_per_tok:
            counts1[e] = 1
    rows = {f"{MOE_KERNEL}/step_B8": moe_kernel_row(torch, flush, layer, counts8, 50),
            f"{MOE_KERNEL}/step_B1": moe_kernel_row(torch, flush, layer, counts1, 51),
            f"{MOE_KERNEL}/chunk_512": moe_kernel_row(torch, flush, layer,
                                                      MOE_PARITY["R1024"], 52)}
    rows[MOE_KERNEL] = rows[f"{MOE_KERNEL}/step_B8"]
    del flush
    walls = [run["wall"] for run in g4["serve"]]
    out_tokens = sum(len(t) for t, _, _ in first["outs"])
    res = {
        "card": card, "layers": L, "config": "Mixtral-8x7B (published config.json), "
        f"{L} of 32 layers, random bf16 weights from seed 0",
        "weights_bytes": wbytes, "expert_bytes": experts, "kv_blocks": runner.num_blocks,
        "parity_max_abs_err": errs, "dropless_vs_f32_oracle_max_abs_err": oracle_err,
        "stats": first["stats"], "launches": first["launches"],
        "serve_wall_s": walls, "output_tok_per_s_warm": out_tokens / walls[1],
        "ttft_s_warm": [t for _, _, t in warm["outs"]],
        "reference_max_logit_gap": gap, "reference_bound": MOE_REF_GAP,
        "replay_vs_eager_bitwise": {n: list(s) for n, s in bitwise.items()},
        "step_ms": steps, "kernel_rows": rows, "step_routing_B8": counts8,
        "graph_mem_bytes": mem_graphs, "serve_peak_mem_bytes": first["peak"],
        "engine_peak_mem_bytes": first["peak"] - mem_before,
        "capture_s": {k: s["capture_s"] for k, s in runner.graph_stats().items()},
        "phase_s": time.perf_counter() - t_phase,
    }
    print(json.dumps({"serve_moe": res}), flush=True)
    r8 = rows[MOE_KERNEL]
    log(f"serve_moe: {len(reqs)} requests ({out_tokens} tokens) warm {walls[1]:.2f} s "
        f"({res['output_tok_per_s_warm']:.1f} tokens/s); launches {first['launches']}; "
        f"every replay bitwise = eager; graphs hold {mem_graphs / 1e6:.1f} MB; serve peak "
        f"{first['peak'] / 1e9:.2f} GB; phase {res['phase_s']:.1f} s ({card})")
    for name, row in steps.items():
        log(f"serve_moe: graphed step {name}: {row['wall_ms']:.2f} ms wall / "
            f"{row['device_ms']:.2f} device; grouped kernel {row['grouped_kernel_ms']:.2f} ms "
            f"({100 * row['grouped_kernel_share']:.1f}%), MoE layers "
            f"{100 * row['moe_layers_share']:.1f}% ({card})")
    for name, row in rows.items():
        log(f"serve_moe: {name}: {row['ms']['median']:.4f} ms (bound {row['bound_ms']:.4f}, "
            f"{row['bound_by']}; {row['experts_routed']} experts), plain "
            f"{row['plain_ms']['median']:.4f}, library {row['library_ms']['median']:.4f} "
            f"[{row['library']}] ({card})")
    res["errs"] = {MOE_KERNEL: max(errs.values())}
    res["rows"] = rows
    # the ep leg on the card this phase's engine frees
    del engine, runner, layer, g4, first, warm
    gc.collect()
    torch.cuda.empty_cache()
    res["ep"] = serve_moe_ep(torch, np, card)
    return res


# ------------------------------------------------------------ serve_ops

OPS_INFLIGHT = 6  # DYN_ADMISSION_MAX_INFLIGHT: bulk sheds at 3, standard at 5, interactive at 6
OPS_OUT = 16  # greedy tokens per request
OPS_CHECK = 8  # tokens of an admitted stream held to the dense reference
OPS_SCRAPE_TURNS = ("none", "scrape", "scrape", "none")
OPS_STREAMS = 4  # concurrent standard streams of a tokens/s turn
OPS_SLOW = 3  # DYN_FAULT=slow_decode on the gray worker
OPS_PAIRS = 6  # interactive prompts sent unhedged, then hedged
OPS_LONG = 2000  # their length: a prefill long enough to tell the gray worker apart
OPS_AFTER = 12  # requests sent after the ejection
OPS_BROWNOUT = {"DYN_BROWNOUT_STEP_UP_S": "0.5", "DYN_BROWNOUT_STEP_DOWN_S": "1.0",
                "DYN_BROWNOUT_MAX_LEVEL": "3"}
OPS_WORKER_ARGS: list = []  # extra worker CLI flags (none on the card)
OPS_WORKER_ENV: dict = {}  # extra worker environment (none on the card)


def parse_prom(text: str) -> dict:
    """The Prometheus text format, read with the standard library:
    {family: {"type": t, "samples": [(sample name, {label: value}, value)]}}."""
    fams: dict = {}
    cur = None
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            name, typ = line[7:].split(" ", 1)
            base = name[:-6] if typ == "counter" and name.endswith("_total") else name
            cur = fams.setdefault(base, {"type": typ, "samples": []})
            continue
        if not line or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        name, labels = head, {}
        if "{" in head:
            name, body = head[:-1].split("{", 1)
            for part in body.split('",'):
                k, _, v = part.partition('="')
                labels[k.strip(",")] = v.rstrip('"').replace('\\"', '"').replace("\\\\", "\\")
        if cur is None:
            raise SmokeError(f"a sample before any TYPE line: {line!r}")
        cur["samples"].append((name, labels, float(value)))
    return fams


def prom_value(fams: dict, family: str, suffix: str = "", **labels) -> float:
    """The sum of a family's samples named ``family + suffix`` whose labels
    include ``labels``."""
    fam = fams.get(family)
    if fam is None:
        raise SmokeError(f"no {family} family")
    want = family + (suffix or ("_total" if fam["type"] == "counter" else ""))
    return sum(v for n, lab, v in fam["samples"]
               if n == want and all(lab.get(k) == str(x) for k, x in labels.items()))


def scrape(port: int) -> tuple:
    """(parsed families, ms) of one GET /metrics."""
    t0 = time.perf_counter()
    st, data = http_call(port, "GET", "/metrics", timeout=30)
    ms = (time.perf_counter() - t0) * 1e3
    if st != 200:
        raise SmokeError(f"GET /metrics on :{port} answered {st}")
    return parse_prom(data.decode()), ms


def ops_stream(port: int, ids: list, rid: str, priority: str = "standard",
               max_tokens: int = OPS_OUT) -> dict:
    """One streamed greedy /v1/completions of token ids under a class: the
    token strings (through logprobs) and the TTFT, or, when the frontend
    answers otherwise than 200, the status, Retry-After and error body."""
    import http.client

    from dynamo_tpu_torch.protocols.sse import SseParser

    body = {"model": "llama31-8b", "prompt": ids, "max_tokens": max_tokens, "temperature": 0,
            "stream": True, "logprobs": 0, "nvext": {"ignore_eos": True},
            "stream_options": {"include_usage": True}}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT_S)
    parser, tokens, times, finish = SseParser(), [], [], []
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/v1/completions", body=json.dumps(body), headers={
            "Content-Type": "application/json", "x-request-id": rid, "x-dyn-priority": priority})
        resp = conn.getresponse()
        if resp.status != 200:
            data = resp.read()
            return {"status": resp.status, "ms": (time.perf_counter() - t0) * 1e3,
                    "retry_after": resp.getheader("Retry-After"), "body": json.loads(data)}
        while True:
            line = resp.readline()
            if not line:
                break
            for ev in parser.feed(line.decode("utf-8")):
                if ev.is_done():
                    continue
                if ev.event is not None:
                    raise SmokeError(f"{rid}: the stream carried an error event: {ev.data}")
                for ch in ev.json().get("choices", []):
                    for t in (ch.get("logprobs") or {}).get("tokens") or []:
                        tokens.append(t)
                        times.append(time.perf_counter())
                    if ch.get("finish_reason"):
                        finish.append(ch["finish_reason"])
    finally:
        conn.close()
    if len(tokens) != max_tokens or finish != ["length"]:
        raise SmokeError(f"{rid}: {len(tokens)} tokens, finish {finish}")
    return {"status": 200, "tokens": tokens, "ttft_ms": (times[0] - t0) * 1e3,
            "wall_s": time.perf_counter() - t0}


def shed_once(port: int, ids: list, rid: str, priority: str) -> dict:
    """One request that the frontend is expected to answer at once: its
    status, Retry-After and milliseconds to the answer."""
    import http.client

    body = {"model": "llama31-8b", "prompt": ids, "max_tokens": OPS_OUT, "temperature": 0,
            "stream": False}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT_S)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/v1/completions", body=json.dumps(body), headers={
            "Content-Type": "application/json", "x-request-id": rid, "x-dyn-priority": priority})
        resp = conn.getresponse()
        data = resp.read()
        return {"status": resp.status, "ms": (time.perf_counter() - t0) * 1e3,
                "retry_after": resp.getheader("Retry-After"), "body": json.loads(data)}
    finally:
        conn.close()


def direct_calls(fport: int, calls: list) -> None:
    """Each (instance id, token ids, max tokens) served by that worker
    directly over the fabric, greedy, one after another (warm-ups that no
    frontend sees)."""
    from dynamo_tpu_torch.pipeline.context import Context
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    async def go():
        drt = await DistributedRuntime.from_settings(RuntimeConfig(fabric_addr=f"127.0.0.1:{fport}"))
        try:
            client = await drt.namespace("dynamo").component("backend").endpoint("generate").client()
            await client.wait_for_instances(30.0)
            for iid, ids, n in calls:
                req = PreprocessedRequest(token_ids=list(ids), sampling=SamplingOptions(greedy=True),
                                          stop=StopConditions(max_tokens=n, ignore_eos=True))
                stream = await client.direct(req.to_dict(), iid, Context())
                async for item in stream:
                    if item.is_error():
                        raise SmokeError(f"a direct call to {iid:x}: {item.error_message()}")
                    if (item.data or {}).get("finish_reason"):
                        break
                await stream.close()
            await client.close()
        finally:
            await drt.close()

    asyncio.run(go())


class EventTap:
    """A subscription, in a thread of its own, to namespace events: each
    event with its arrival on time.perf_counter's clock."""

    def __init__(self, fport: int, subjects: tuple) -> None:
        import threading

        self.events: list = []
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._thread = threading.Thread(target=lambda: asyncio.run(self._run(fport, subjects)),
                                        daemon=True)
        self._thread.start()
        if not self._ready.wait(30):
            raise SmokeError("the event subscription did not come up")

    async def _run(self, fport: int, subjects: tuple) -> None:
        from dynamo_tpu_torch.fabric import mpack
        from dynamo_tpu_torch.runtime.config import RuntimeConfig
        from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

        drt = await DistributedRuntime.from_settings(RuntimeConfig(fabric_addr=f"127.0.0.1:{fport}"))
        ns = drt.namespace("dynamo")

        async def pump(sub, subject):
            async for _s, payload in sub:
                self.events.append((time.perf_counter(), subject, mpack.unpackb(payload)))

        subs = [(await ns.subscribe_event(s), s) for s in subjects]
        tasks = [asyncio.get_running_loop().create_task(pump(sub, s)) for sub, s in subs]
        self._ready.set()
        while not self._stop.is_set():
            await asyncio.sleep(0.05)
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        await drt.close()

    def of(self, subject: str) -> list:
        return [(t, p) for t, s, p in list(self.events) if s == subject]

    def close(self) -> None:
        self._stop.set()
        self._thread.join(30)


def phase_serve_ops(torch, np, card: str) -> dict:
    """The frontend's operating plane across processes (see the module
    docstring, phase 21)."""
    import signal
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.runtime import logging as dlog
    from dynamo_tpu_torch.telemetry import trace as dtrace
    from dynamo_tpu_torch.tokenizer import TokenizerWrapper

    t_phase = time.perf_counter()
    model_dir = write_serve_dir()
    root = os.path.dirname(os.path.abspath(__file__))
    py = sys.executable
    fport, hport, bport, cport, dport, eport, rport = (free_port() for _ in range(7))
    wports = {"worker0": free_port(), "worker1": free_port()}
    trace_dirs = {k: os.path.join(SERVE_DIR, f"ops_traces_{k}") for k in ("a", "b")}
    base = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
                DYN_FABRIC_ADDR=f"127.0.0.1:{fport}", DYN_LEASE_TTL_S=str(FABRIC_TTL_S),
                **OPS_BROWNOUT)
    for k in ("DYN_FAULT", "DYN_TRACE", "DYN_SLO_TTFT_MS", "DYN_SLO_ITL_MS", "DYN_HEDGE"):
        base.pop(k, None)

    def worker(name: str, fault: Optional[str] = None) -> tuple:
        # no local objective: the worker's ladder steps on the fleet's
        # slo-status events and its tick (DYN_SLO_TICK_S)
        env = dict(base, DYN_RUNTIME_HTTP_ENABLED="1", DYN_RUNTIME_HTTP_PORT=str(wports[name]),
                   DYN_SLO_TICK_S="0.25", **OPS_WORKER_ENV)
        if fault:
            env["DYN_FAULT"] = fault
        return ([py, "-m", "dynamo_tpu_torch.run", "in=dyn://dynamo.backend.generate", "out=torch",
                 "--model-path", model_dir, "--model-name", "llama31-8b", "--context-length",
                 str(MAX_MODEL_LEN), "--num-blocks", str(FABRIC_BLOCKS), *OPS_WORKER_ARGS], env)

    def frontend(port: int, mode: str, **env) -> tuple:
        return ([py, "-m", "dynamo_tpu_torch.run", "in=http", "out=dyn", "--router-mode", mode,
                 "--http-host", "127.0.0.1", "--http-port", str(port)], dict(base, **env))

    specs = {
        "fabric": ([py, "-m", "dynamo_tpu_torch.fabric.server", "--host", "127.0.0.1",
                    "--port", str(fport)], base),
        "worker0": worker("worker0"), "worker1": worker("worker1"),
        # the kv frontend: admission bounded, DYN_TRACE=auto with a loose
        # TTFT objective (its own SLO state stays ok), JSONL logs
        "frontend": frontend(hport, "kv", DYN_ADMISSION_MAX_INFLIGHT=str(OPS_INFLIGHT),
                             DYN_TRACE="auto", DYN_TRACE_SAMPLE="0", DYN_TRACE_DIR=trace_dirs["a"],
                             DYN_SLO_TTFT_MS="60000", DYN_SLO_TICK_S="0.25", DYN_LOGGING_JSONL="1"),
        "router": ([py, "-m", "dynamo_tpu_torch.router", "--block-size", str(BLOCK),
                    "--metrics-port", str(rport)], base),
    }
    procs, logs, files = {}, {}, []
    out: dict = {"card": card}
    rng = np.random.default_rng(21)

    def ids(n: int) -> list:
        return [int(t) for t in rng.integers(256 + 26, 128000, size=n)]

    def start(names) -> None:
        for name in names:
            cmd, env = specs[name]
            path = os.path.join(SERVE_DIR, f"ops_{name}.log")
            f = open(path, "w")
            files.append(f)
            logs[name] = LogTail(path)
            procs[name] = subprocess.Popen(cmd, cwd=root, env=env, stdout=f, stderr=subprocess.STDOUT)
            if name == "fabric":
                time.sleep(1.0)

    def up(port: int, workers: int, names) -> None:
        t0 = time.perf_counter()
        while True:
            for name in names:
                if procs[name].poll() is not None:
                    raise SmokeError(f"{name} exited with {procs[name].returncode} "
                                     f"(see {logs[name].path})")
            try:
                st, data = http_call(port, "GET", "/v1/models", timeout=5)
                if st == 200 and json.loads(data)["data"] and len(fabric_instances(fport)) == workers:
                    return
            except OSError:
                pass
            if time.perf_counter() - t0 > SERVER_START_S:
                raise SmokeError(f"the frontend on :{port} did not see {workers} workers")
            time.sleep(0.2)

    def stop(names) -> None:
        for name in names:
            p = procs.get(name)
            if p is not None and p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for name in names:
            p = procs.get(name)
            if p is not None:
                try:
                    p.wait(60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(30)

    checks: list = []  # (prompt ids, token strings) for the dense reference
    tap = None
    try:
        start(["fabric", "worker0", "worker1", "frontend", "router"])
        iid = {w: logs[w].wait_json("worker", 1, procs[w], SERVER_START_S)[0]["instance_id"]
               for w in ("worker0", "worker1")}
        up(hport, 2, ["fabric", "worker0", "worker1", "frontend", "router"])
        tap = EventTap(fport, ("slo-status", "brownout-status", "health-status"))
        out["start_s"] = time.perf_counter() - t_phase
        log(f"serve_ops: fabric, 2 workers (status servers :{wports['worker0']} / "
            f":{wports['worker1']}), the kv frontend (admission at {OPS_INFLIGHT}, DYN_TRACE=auto) "
            f"and the router (--metrics-port {rport}) up in {out['start_s']:.1f} s")
        sent = 0
        # warm both workers' graphs (their first dispatches capture them)
        with ThreadPoolExecutor(4) as pool:
            warm = list(pool.map(lambda k: ops_stream(hport, ids(64 + 32 * k), f"ops-warm-{k}"),
                                 range(4)))
        sent += len(warm)

        # (a) scrapes, and tokens/s with one scrape a second against none
        import threading

        walls = {"none": [], "scrape": []}
        scrape_ms: dict = {"frontend": [], "worker0": [], "worker1": [], "router": []}
        for turn, mode in enumerate(OPS_SCRAPE_TURNS):
            stop_scraping = threading.Event()

            def scraper():
                while not stop_scraping.wait(1.0):
                    scrape_ms["frontend"].append(scrape(hport)[1])

            th = threading.Thread(target=scraper) if mode == "scrape" else None
            if th is not None:
                th.start()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(OPS_STREAMS) as pool:
                got = list(pool.map(lambda k: ops_stream(hport, ids(128), f"ops-a{turn}-{k}",
                                                         max_tokens=64), range(OPS_STREAMS)))
            walls[mode].append(OPS_STREAMS * 64 / (time.perf_counter() - t0))
            stop_scraping.set()
            if th is not None:
                th.join()
            sent += len(got)
        for _ in range(10):
            for name, port in (("frontend", hport), ("worker0", wports["worker0"]),
                               ("worker1", wports["worker1"]), ("router", rport)):
                scrape_ms[name].append(scrape(port)[1])
        fam, _ = scrape(hport)
        done = prom_value(fam, "dyn_llm_http_service_requests", status="success")
        ttft_n = prom_value(fam, "dyn_llm_http_service_time_to_first_token_seconds", "_count")
        inflight = prom_value(fam, "dyn_llm_http_service_inflight_requests")
        if (done, ttft_n, inflight) != (sent, sent, 0):
            raise SmokeError(f"serve_ops (a): the frontend counted {done} requests, {ttft_n} TTFTs, "
                             f"{inflight} in flight; the script sent {sent}, all done")
        per_worker, gaps = {}, {}
        for w in ("worker0", "worker1"):
            wf, _ = scrape(wports[w])
            per_worker[w] = {ph: prom_value(wf, "dyn_llm_phase_duration_seconds", "_count", phase=ph)
                             for ph in ("ttft", "e2e", "queue_wait")}
            # the inter-token gaps as the engine marks them (one a token
            # gap, cold gaps left out): the share under 2 ms and the p50 / p99
            n = prom_value(wf, "dyn_llm_phase_duration_seconds", "_count", phase="inter_token")
            near0 = max((v for name, lab, v in wf["dyn_llm_phase_duration_seconds"]["samples"]
                         if name.endswith("_bucket") and lab.get("phase") == "inter_token"
                         and lab["le"] != "+Inf" and float(lab["le"]) <= 0.002), default=0.0)
            gaps[w] = {"n": n, "under_2ms": near0 / max(1.0, n), **{
                q: 1e3 * prom_value(wf, "dyn_llm_phase_latency_seconds", phase="inter_token", quantile=q)
                for q in ("p50", "p99")}}
        if sum(v["e2e"] for v in per_worker.values()) != sent or any(
                v["ttft"] != v["e2e"] or v["queue_wait"] != v["e2e"] for v in per_worker.values()):
            raise SmokeError(f"serve_ops (a): the workers' phase histograms count {per_worker}; "
                             f"the script sent {sent} streams")
        found = router_calls(fport, [{"token_ids": ids(64), "request_id": f"ops-r{k}"} for k in range(3)])
        rf, _ = scrape(rport)
        if prom_value(rf, "dyn_llm_router_decisions") != 3 or "dyn_llm_kv_hit_rate" not in rf:
            raise SmokeError(f"serve_ops (a): the router's /metrics after 3 decisions: "
                             f"{rf.get('dyn_llm_router_decisions')}")
        rate = {k: statistics.mean(v) for k, v in walls.items()}
        out["a"] = {"families": len(fam), "scrape_ms": {k: statistics.median(v) for k, v in scrape_ms.items()},
                    "tok_per_s": rate, "scraped_over_none": rate["scrape"] / rate["none"],
                    "worker_phase_counts": per_worker, "inter_token_ms": gaps,
                    "router_workers": [f["worker_id"] for f in found]}
        log(f"serve_ops (a): {len(fam)} families on the frontend's /metrics; requests {done:.0f}, TTFT "
            f"count {ttft_n:.0f}, inflight {inflight:.0f} = the {sent} sent; the workers' phase "
            f"histograms count {per_worker['worker0']['e2e']:.0f} + {per_worker['worker1']['e2e']:.0f} "
            f"streams; scrape median ms: " + ", ".join(f"{k} {v:.2f}" for k, v in out["a"]["scrape_ms"].items())
            + f"; {OPS_STREAMS} streams' tokens/s with a scrape a second / none "
            f"{rate['scrape']:.1f} / {rate['none']:.1f} = {out['a']['scraped_over_none']:.4f} ({card}); "
            f"at {time.perf_counter() - t_phase:.1f} s")
        log("serve_ops (a): the workers' inter_token histograms (one sample a gap, H = 4): "
            + "; ".join(f"{w} {g['n']:.0f} gaps, {100 * g['under_2ms']:.1f}% under 2 ms, p50 "
                        f"{g['p50']:.2f} ms, p99 {g['p99']:.2f} ms" for w, g in gaps.items()))

        # (b) admission: three long standard streams hold the slots, then a
        # burst of every class at once
        holders = [ids(96) for _ in range(3)]
        with ThreadPoolExecutor(16) as pool:
            held = [pool.submit(ops_stream, hport, holders[k], f"ops-hold-{k}", "standard", 160)
                    for k in range(3)]
            t_wait = time.perf_counter()
            while prom_value(scrape(hport)[0], "dyn_llm_http_service_inflight_requests") < 3:
                if time.perf_counter() - t_wait > 60:
                    raise SmokeError("serve_ops (b): the holding streams never became inflight")
                time.sleep(0.05)
            burst = [("bulk", ids(80)) for _ in range(3)] + [("standard", ids(80)) for _ in range(2)] \
                + [("interactive", ids(80))]
            futs = [pool.submit(ops_stream, hport, p, f"ops-b{k}-{c}", c) for k, (c, p) in enumerate(burst)]
            results = [f.result() for f in futs]
            held = [f.result() for f in held]
        shed = {c: sum(1 for (cc, _), r in zip(burst, results) if cc == c and r["status"] == 429)
                for c in ("bulk", "standard", "interactive")}
        retry = [int(r["retry_after"]) for r in results if r["status"] == 429]
        if shed["bulk"] != 3 or not shed["bulk"] >= shed["standard"] >= shed["interactive"]:
            raise SmokeError(f"serve_ops (b): sheds by class {shed}: bulk must go first and whole")
        if not retry or not all(1 <= r <= 60 for r in retry):
            raise SmokeError(f"serve_ops (b): Retry-After values {retry}")
        for (c, p), r in zip(burst, results):
            if r["status"] == 200:
                checks.append((p, r["tokens"]))
            elif r["body"]["error"]["type"] != "overloaded":
                raise SmokeError(f"serve_ops (b): a shed answered {r['body']}")
        for p, r in zip(holders, held):
            checks.append((p, r["tokens"]))
        one = shed_once(hport, ids(80), "ops-b-one", "bulk")  # nothing in flight: admitted
        sent += 1 + sum(r["status"] == 200 for r in results) + len(held)
        # a 429's answer time: hold the slots again and time bulk sheds alone
        with ThreadPoolExecutor(4) as pool:
            held2 = [pool.submit(ops_stream, hport, ids(96), f"ops-hold2-{k}", "standard", 96)
                     for k in range(3)]
            while prom_value(scrape(hport)[0], "dyn_llm_http_service_inflight_requests") < 3:
                time.sleep(0.05)
            sheds = [shed_once(hport, ids(80), f"ops-b429-{k}", "bulk") for k in range(5)]
            for f in held2:
                f.result()
        if one["status"] != 200 or any(s["status"] != 429 for s in sheds):
            raise SmokeError(f"serve_ops (b): an idle bulk request answered {one['status']}, bulk "
                             f"past the watermark {[s['status'] for s in sheds]}")
        fam, _ = scrape(hport)
        out["b"] = {"shed_by_class": shed, "retry_after_s": retry,
                    "shed_answer_ms": statistics.median(s["ms"] for s in sheds),
                    "class_shed_metric": {c: prom_value(fam, "dyn_llm_class_requests_shed", priority=c)
                                          for c in ("bulk", "standard", "interactive")}}
        log(f"serve_ops (b): with 3 standard streams in flight (watermark {OPS_INFLIGHT}), a burst of "
            f"3 bulk, 2 standard, 1 interactive: 429 by class {shed}; Retry-After {retry} s; a 429 "
            f"answered in {out['b']['shed_answer_ms']:.2f} ms (median of 5) ({card}); at "
            f"{time.perf_counter() - t_phase:.1f} s")

        # (c) SLO and brownout: a second frontend with a TTFT objective no
        # request meets breaches; its slo-status events drive every ladder
        specs["frontend_b"] = frontend(bport, "round_robin", DYN_SLO_TTFT_MS="1",
                                       DYN_SLO_FAST_WINDOW_S="2", DYN_SLO_SLOW_WINDOW_S="4",
                                       DYN_SLO_TICK_S="0.25", DYN_TRACE="auto", DYN_TRACE_SAMPLE="0",
                                       DYN_TRACE_DIR=trace_dirs["b"])
        start(["frontend_b"])
        up(bport, 2, ["frontend_b"])
        def worker_stats() -> dict:
            seen = {w: len(logs[w].json_lines("worker_stats")) for w in ("worker0", "worker1")}
            for w in ("worker0", "worker1"):
                procs[w].send_signal(signal.SIGUSR1)
            return {w: logs[w].wait_json("worker_stats", seen[w] + 1, procs[w], 30)[-1]
                    for w in ("worker0", "worker1")}

        stats_before = worker_stats()
        keep = threading.Event()

        def breach_traffic():
            k = 0
            while not keep.is_set():
                ops_stream(bport, ids(32), f"ops-c-slow-{k}", max_tokens=4)
                k += 1
                keep.wait(0.3)

        t_c = time.perf_counter()
        traffic = threading.Thread(target=breach_traffic)
        traffic.start()
        try:
            deadline = time.perf_counter() + 30
            while True:
                levels = {w: prom_value(scrape(wports[w])[0], "dyn_llm_brownout_level")
                          for w in ("worker0", "worker1")}
                slo_a = json.loads(http_call(hport, "GET", "/debug/slo")[1])
                if min(levels.values()) >= 3 and slo_a["brownout"]["level"] >= 3:
                    break
                if time.perf_counter() > deadline:
                    raise SmokeError(f"serve_ops (c): the ladders reached {levels}, frontend "
                                     f"{slo_a['brownout']['level']}")
                time.sleep(0.1)
            slo_b = json.loads(http_call(bport, "GET", "/debug/slo")[1])
            if slo_b["models"]["llama31-8b"]["state"] != "breached":
                raise SmokeError(f"serve_ops (c): the SLO frontend's /debug/slo: {slo_b}")
            bulk = shed_once(hport, ids(40), "ops-c-bulk", "bulk")
            if bulk["status"] != 429:
                raise SmokeError(f"serve_ops (c): bulk under brownout answered {bulk['status']}")
            # rung 3 on the workers: a 2000-token prompt runs in chunks of 256
            ops_stream(hport, ids(2000), "ops-c-capped", max_tokens=4)
            sent += 1
            stats_capped = worker_stats()
        finally:
            keep.set()
            traffic.join()
        chunks = sum(stats_capped[w]["chunk_steps"] - stats_before[w]["chunk_steps"]
                     for w in ("worker0", "worker1"))
        if chunks != -(-2000 // 256):
            raise SmokeError(f"serve_ops (c): the capped 2000-token prompt ran {chunks} chunks, "
                             f"not {-(-2000 // 256)} of 256")
        deadline = time.perf_counter() + 40
        while True:
            levels = {w: prom_value(scrape(wports[w])[0], "dyn_llm_brownout_level")
                      for w in ("worker0", "worker1")}
            slo_a = json.loads(http_call(hport, "GET", "/debug/slo")[1])
            if max(levels.values()) == 0 and slo_a["brownout"]["level"] == 0:
                break
            if time.perf_counter() > deadline:
                raise SmokeError(f"serve_ops (c): the ladders stayed at {levels}, frontend "
                                 f"{slo_a['brownout']['level']}")
            time.sleep(0.1)
        t_rec = time.perf_counter()
        slo_ev = tap.of("slo-status")
        ladder = tap.of("brownout-status")
        if not any(p.get("new") == "breached" for _, p in slo_ev) or not any(
                p.get("new") == "ok" for _, p in slo_ev):
            raise SmokeError(f"serve_ops (c): slo-status events {[p for _, p in slo_ev]}")
        t_breach = min(t for t, p in slo_ev if p.get("new") == "breached")
        scopes: dict = {}
        for t, p in ladder:
            scopes.setdefault(p["scope"], []).append((round((t - t_breach) * 1e3, 1), p["level"],
                                                      p["spec_off"], p["chunk_cap"]))
        workers_ev = {s: v for s, v in scopes.items() if s.startswith("backend")}
        for s, v in workers_ev.items():
            lv = [x[1] for x in v]
            if lv != [1, 2, 3, 2, 1, 0] or not (v[1][2] and v[2][3]):
                raise SmokeError(f"serve_ops (c): worker {s}'s ladder went {v}")
        if len(workers_ev) != 2:
            raise SmokeError(f"serve_ops (c): ladder events from {list(scopes)}")
        # DYN_TRACE=auto: the slow requests kept at the SLO frontend, the
        # fast ones dropped at the kv frontend, an errored one kept there
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", hport, timeout=60)
        try:
            conn.request("POST", "/v1/completions", body=json.dumps({
                "model": "llama31-8b", "prompt": ids(16), "max_tokens": 64, "stream": False,
                "ext": {"timeout_ms": 1}}), headers={"Content-Type": "application/json",
                                                     "x-request-id": "ops-c-err"})
            resp = conn.getresponse()
            err = (resp.status, json.loads(resp.read()))
        finally:
            conn.close()
        traces_a = json.loads(http_call(hport, "GET", "/debug/traces")[1])
        traces_b = json.loads(http_call(bport, "GET", "/debug/traces")[1])
        kept_a = {e["request_id"]: e["reason"] for e in traces_a["traces"]}
        kept_b = {e["request_id"]: e["reason"] for e in traces_b["traces"]}
        if err[0] != 504 or kept_a != {"ops-c-err": "error:deadline_exceeded"} or \
                traces_a["stats"]["dropped"] < sent or not kept_b or \
                set(kept_b.values()) != {"slo_ttft"}:
            raise SmokeError(f"serve_ops (c): DYN_TRACE=auto kept {kept_a} (dropped "
                             f"{traces_a['stats']['dropped']}) at the kv frontend, {len(kept_b)} "
                             f"{set(kept_b.values())} at the SLO frontend; the errored request "
                             f"answered {err[0]}")
        stop(["frontend_b"])
        out["c"] = {"ladders_ms_from_breach": scopes, "recovered_s": t_rec - t_c,
                    "chunk_steps_capped": chunks, "auto_kept": {"kv": kept_a, "slo": len(kept_b)},
                    "auto_dropped_kv": traces_a["stats"]["dropped"]}
        log(f"serve_ops (c): the SLO frontend breached and published slo-status; ladder transitions "
            f"(ms after the breach event, level, spec_off, chunk_cap): "
            + "; ".join(f"{s} {v}" for s, v in scopes.items())
            + f"; bulk shed at the kv frontend, a 2000-token prompt in {chunks} chunks of 256 on "
              f"the workers at rung 3; every ladder back at 0 {t_rec - t_c:.1f} s after the breach "
              f"traffic began; DYN_TRACE=auto kept {len(kept_b)} slow (slo_ttft) at the SLO "
              f"frontend, the errored one (error:deadline_exceeded) at the kv frontend and dropped "
              f"its {traces_a['stats']['dropped']} fast ones; at {time.perf_counter() - t_phase:.1f} s")

        # (d) tail tolerance: worker1 drained and started again gray
        # (slow_decode=3); three round-robin frontends: C with DYN_HEDGE=1
        # and D without, both keeping every worker in rotation
        # (DYN_EJECT_INTERVALS), and E, whose scorer ejects (at 2x the fleet
        # median); the warm-ups go to the workers directly, so C's hedge
        # delay learns from its own interactive requests only
        stop(["worker1"])
        w1_exit = logs["worker1"].json_lines("exit_stats")[-1]
        specs["worker1g"] = worker("worker1", fault=f"slow_decode={OPS_SLOW}")
        keep_all = {"DYN_EJECT_INTERVALS": "1000000"}
        # the hedge delay's floor between the healthy worker's 2000-token
        # TTFT (~200-330 ms) and the gray one's less the healthy one's, so
        # only gray primaries hedge and their hedges can win; every
        # dispatch may hedge
        specs["frontend_c"] = frontend(cport, "round_robin", DYN_HEDGE="1", DYN_HEDGE_BUDGET="1.0",
                                       DYN_HEDGE_MIN_MS="350", **keep_all)
        specs["frontend_d"] = frontend(dport, "round_robin", **keep_all)
        specs["frontend_e"] = frontend(eport, "round_robin", DYN_EJECT_RATIO="2.0")
        start(["worker1g", "frontend_c", "frontend_d", "frontend_e"])
        gray = logs["worker1g"].wait_json("worker", 1, procs["worker1g"], SERVER_START_S)[0]["instance_id"]
        for port, name in ((cport, "frontend_c"), (dport, "frontend_d"), (eport, "frontend_e")):
            up(port, 2, ["worker1g", name])
        t_gray = time.perf_counter()
        direct_calls(fport, [(gray, ids(OPS_LONG), 4) for _ in range(2)]
                     + [(iid["worker0"], ids(OPS_LONG), 4)])
        prompts = [ids(OPS_LONG) for _ in range(OPS_PAIRS)]
        plain = [ops_stream(dport, p, f"ops-d{k}-plain", "interactive") for k, p in enumerate(prompts)]
        hedged = []
        for k, p in enumerate(prompts):
            hedged.append(ops_stream(cport, p, f"ops-d{k}-hedged", "interactive"))
            if hedged[-1]["tokens"] != plain[k]["tokens"]:
                raise SmokeError(f"serve_ops (d): prompt {k}: the hedged stream's tokens differ from "
                                 f"the unhedged one's")
        checks.append((prompts[0], hedged[0]["tokens"]))
        log("serve_ops (d): TTFT ms per prompt, unhedged "
            + str([round(r["ttft_ms"], 1) for r in plain]) + ", hedged "
            + str([round(r["ttft_ms"], 1) for r in hedged]))
        fam, _ = scrape(cport)
        hedges = {o: prom_value(fam, "dyn_llm_hedges", outcome=o) for o in ("won", "lost", "budget_denied")}
        if hedges["won"] < 1:
            raise SmokeError(f"serve_ops (d): no hedge won over {len(prompts)} requests: {hedges}")
        deadline = time.perf_counter() + 40
        while prom_value(scrape(eport)[0], "dyn_llm_workers_ejected") < 1:
            if time.perf_counter() > deadline:
                raise SmokeError(f"serve_ops (d): the gray worker was not ejected: "
                                 f"{scrape(eport)[0].get('dyn_llm_worker_health_score')}")
            ops_stream(eport, ids(32), f"ops-d-tick-{time.perf_counter():.3f}", max_tokens=4)
        t_eject = time.perf_counter() - t_gray
        fam, _ = scrape(eport)
        scores = {lab["instance"]: v for _, lab, v in fam["dyn_llm_worker_health_score"]["samples"]}
        if scores.get(f"{gray:x}", 0) < 2.0:
            raise SmokeError(f"serve_ops (d): ejected, but the gray worker scores {scores}")
        before = prom_value(scrape(wports["worker1"])[0], "dyn_llm_phase_duration_seconds", "_count",
                            phase="e2e")
        for k in range(OPS_AFTER):
            ops_stream(eport, ids(32), f"ops-d-after-{k}", max_tokens=4)
        reached = prom_value(scrape(wports["worker1"])[0], "dyn_llm_phase_duration_seconds", "_count",
                             phase="e2e") - before
        if reached > 2:
            raise SmokeError(f"serve_ops (d): {reached:.0f} of {OPS_AFTER} requests after the "
                             f"ejection reached the gray worker (probes: 1 in 16)")
        stop(["frontend_c", "frontend_d", "frontend_e"])

        def pct(xs, p):
            return sorted(xs)[min(len(xs) - 1, int(p * len(xs)))]

        ttft = {"hedged": [r["ttft_ms"] for r in hedged], "unhedged": [r["ttft_ms"] for r in plain]}
        out["d"] = {"requests": len(prompts), "hedges": hedges, "worker1_drained": {
            k: w1_exit[k] for k in ("busy_lanes", "free_blocks", "num_blocks")},
            "ttft_ms": {k: {"p50": pct(v, 0.5), "p99": pct(v, 0.99)} for k, v in ttft.items()},
            "gray_score": scores.get(f"{gray:x}"), "eject_s": t_eject,
            "after_ejection_reached_gray": reached}
        t = out["d"]["ttft_ms"]
        log(f"serve_ops (d): the gray worker {gray:x} (slow_decode={OPS_SLOW}); {len(prompts)} "
            f"interactive {OPS_LONG}-token prompts through round robin: hedged streams equal the "
            f"unhedged ones; hedges {hedges}; TTFT p50 / p99 hedged {t['hedged']['p50']:.1f} / "
            f"{t['hedged']['p99']:.1f} ms, unhedged {t['unhedged']['p50']:.1f} / "
            f"{t['unhedged']['p99']:.1f} ms; the third frontend's scorer ejected it by "
            f"{t_eject:.1f} s after it registered (score "
            f"{scores.get(f'{gray:x}'):.2f}), then {reached:.0f} of {OPS_AFTER} requests reached it "
            f"({card}); at {time.perf_counter() - t_phase:.1f} s")

        # (e) a tools request and /v1/responses at the kv frontend; JSONL logs
        st, data = http_call(hport, "POST", "/v1/chat/completions", {
            "model": "llama31-8b", "messages": [{"role": "user", "content": "weather in Paris?"}],
            "max_tokens": 8, "temperature": 0, "stream": False,
            "tools": [{"type": "function", "function": {"name": "get_weather", "parameters": {}}}]})
        st2, data2 = http_call(hport, "POST", "/v1/responses", {
            "model": "llama31-8b", "input": "hello", "max_output_tokens": 8, "temperature": 0})
        if st != 200 or st2 != 200 or json.loads(data2)["object"] != "response":
            raise SmokeError(f"serve_ops (e): tools answered {st} {data[:200]!r}, responses {st2} "
                             f"{data2[:200]!r}")
        out["e"] = {"tools_finish": json.loads(data)["choices"][0]["finish_reason"],
                    "responses_text": json.loads(data2)["output"][0]["content"][0]["text"]}
    finally:
        if tap is not None:
            tap.close()
        stop(["frontend_c", "frontend_d", "frontend_e", "frontend_b", "frontend", "router"])
        stop(["worker0", "worker1g", "worker1"])
        stop(["fabric"])
        for f in files:
            f.close()
    exits = {w: logs[w].json_lines("exit_stats")[-1] for w in ("worker0", "worker1g")}
    for w, st in exits.items():
        if st["busy_lanes"] or st["free_blocks"] != st["num_blocks"] - 1:
            raise SmokeError(f"serve_ops: {w} exited holding {st['busy_lanes']} lanes, "
                             f"{st['num_blocks'] - 1 - st['free_blocks']} blocks")
    if out["d"]["worker1_drained"]["busy_lanes"] or (out["d"]["worker1_drained"]["free_blocks"]
                                                     != out["d"]["worker1_drained"]["num_blocks"] - 1):
        raise SmokeError(f"serve_ops: the drained worker1 held {out['d']['worker1_drained']}")
    launches = {w: {k: v for k, v in st["kernel_launches"].items() if v} for w, st in exits.items()}
    log(f"serve_ops: kernel launches (workers' exit stats; #1 by graph replays, #3 only where a "
        f"worker runs a prompt single-shot): {launches}; graph replays "
        f"{ {w: st['graph_replays'] for w, st in exits.items()} }")
    jsonl = other = 0
    with open(logs["frontend"].path) as f:
        for line in f:
            if line.startswith('{"time"'):
                json.loads(line)
                jsonl += 1
            elif line.strip() and not line.startswith(("{", "serving ")):
                other += 1
    # a with_fields line under a trace span carries the trace id (the JSONL
    # formatter of the frontend's DYN_LOGGING_JSONL=1, in this process)
    import io
    import logging as pylog

    buf = io.StringIO()
    handler = pylog.StreamHandler(buf)
    handler.setFormatter(dlog.JsonlFormatter())
    lg = dlog.get_logger("chip_smoke.serve_ops")
    lg.addHandler(handler)
    lg.setLevel(pylog.INFO)
    was = dtrace.enabled()
    dtrace.set_enabled(True)
    try:
        from dynamo_tpu_torch.pipeline.context import Context

        ctx = Context(id="ops-log")
        with dtrace.root_span("http_request", ctx, request_id=ctx.id):
            dlog.with_fields(lg, pylog.INFO, "served", tokens=OPS_OUT)
        line = json.loads(buf.getvalue().splitlines()[0])
        if line.get("trace_id") != dtrace.ctx_trace_id(ctx) or line.get("request_id") != "ops-log":
            raise SmokeError(f"serve_ops (e): a JSONL with_fields line {line}")
    finally:
        dtrace.set_enabled(was)
        lg.removeHandler(handler)
    out["e"]["frontend_jsonl_lines"] = jsonl
    log(f"serve_ops (e): a tools request answered 200 (finish {out['e']['tools_finish']}), "
        f"/v1/responses 200; the kv frontend wrote {jsonl} JSONL log lines (DYN_LOGGING_JSONL=1; "
        f"{other} other), a with_fields line under a span carries its trace and request ids")

    # every admitted and hedged stream checked against the dense reference
    t_ref = time.perf_counter()
    engine = build_torch_engine(model_dir, device="cuda", max_model_len=MAX_MODEL_LEN, num_blocks=64)
    tok = TokenizerWrapper.from_file(os.path.join(model_dir, "tokenizer.json"))
    ids_of: dict = {}
    for i in range(LLAMA31_8B["vocab_size"]):
        ids_of.setdefault(tok.decode([i], skip_special_tokens=False), []).append(i)
    try:
        gaps = [kv_reference_check(torch, engine.runner, p, toks, ids_of, n_check=OPS_CHECK)
                for p, toks in checks]
    finally:
        asyncio.run(engine.close())
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    out["reference_max_logit_gap"] = max(gaps)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"serve_ops: {len(gaps)} streams agree with the dense reference (first {OPS_CHECK} tokens, "
        f"largest logit gap {max(gaps):.4f}; {time.perf_counter() - t_ref:.1f} s); phase "
        f"{out['phase_s']:.1f} s")
    print(json.dumps({"serve_ops": out}), flush=True)
    return out


# -------------------------------------------------------------- serve_mm
#
# Multimodal serving and embeddings (ROADMAP A6) on the card: the vision
# tower's embeddings spliced over placeholder rows by the prefill, whose
# attention is kernel #3.

# CLIP ViT-L/14 at 336 px (LLaVA-1.5's tower): 576 patches, hidden 1024, 24
# layers of 16 heads, projected to the language model's 4096
MM_VIT = dict(image_size=336, patch_size=14, hidden_size=1024, num_layers=24, num_heads=16,
              mlp_ratio=4, out_dim=HIDDEN)
MM_IMAGES = 4  # image chats served at once, beside one clip
MM_TEXT = 64  # text tokens beside each medium
MM_OUT = 16  # greedy tokens out per request
MM_FRAMES = 8  # the clip's frames: a span of 8 x 576 rows
MM_PLACEHOLDER = 128002  # one of Llama-3's reserved special ids
MM_MAX_LEN = 8192  # the clip's 4608-row span and its text fit
MM_BLOCKS = 1024  # the mm engine's KV pool: 1 GiB at 16 layers
MM_TOL = 2.0 ** -4  # of a row's max: the bar PERF.md section 2 holds TP / CP / EP logits to
MM_GRAPH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "serve_mm_graph")
MM_GRAPH_HBM_GB = "8"  # the graph worker's KV budget (DYN_HBM_GB)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    import struct
    import zlib

    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png_scanlines(np, img) -> bytes:
    """An RGB image's zlib stream, rows filtered None, Sub and Up in turn."""
    import zlib

    h, w, _ = img.shape
    rows = img.reshape(h, w * 3).astype(np.int16)
    zero = np.zeros(w * 3, np.int16)
    out = []
    for y in range(h):
        ft = y % 3
        pred = (np.concatenate([zero[:3], rows[y, :-3]]) if ft == 1
                else rows[y - 1] if ft == 2 and y else zero)
        out.append(bytes([ft]) + ((rows[y] - pred) % 256).astype(np.uint8).tobytes())
    return zlib.compress(b"".join(out), 6)


def png_bytes(np, img) -> bytes:
    """The script's own PNG writer (8-bit RGB), for the port's stdlib
    reader: the card's machine has no PIL."""
    import struct

    h, w, _ = img.shape
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", _png_scanlines(np, img)) + _png_chunk(b"IEND", b""))


def apng_bytes(np, frames) -> bytes:
    """A clip as an animated PNG (full-canvas RGB frames, 25 fps), the
    video form the port's stdlib reader decodes."""
    import struct

    T, h, w, _ = frames.shape
    out = [b"\x89PNG\r\n\x1a\n", _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
           _png_chunk(b"acTL", struct.pack(">II", T, 0))]
    seq = 0
    for t in range(T):
        out.append(_png_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, 0, 0, 1, 25, 0, 0)))
        seq += 1
        data = _png_scanlines(np, frames[t])
        if t == 0:
            out.append(_png_chunk(b"IDAT", data))
        else:
            out.append(_png_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    out.append(_png_chunk(b"IEND", b""))
    return b"".join(out)


def data_url(media: str, raw: bytes) -> str:
    import base64

    return f"data:{media};base64,{base64.b64encode(raw).decode()}"


def dense_logits_mm(torch, runner, seq: list, emb, start: int = 0):
    """The plain reference's logits over ``seq`` with ``emb`` spliced over
    rows [start, start + M): one forward, the plain attention version, no
    cache, the runner's weights."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops.layers import attn_out, qkv_head

    cfg, params = runner.config, runner.params
    with torch.inference_mode():
        tokens = torch.tensor(seq, device=runner.device)
        positions = torch.arange(len(seq), device=runner.device)
        freqs = llama._rope_pair(cfg, tokens.device)
        x = llama._embed(params, cfg, tokens)
        x[start:start + emb.shape[0]] = emb.to(x.dtype)
        for i, layer in enumerate(params["layers"]):
            q, k, v = qkv_head(x, layer, cfg, llama._layer_freqs(cfg, i, freqs), positions)
            attn = A.causal_prefill_attention_plain(q, k, v, len(seq))
            x = llama._mlp(attn_out(attn, x, layer, cfg), layer, cfg)
        return llama._logits(x[len(seq) - 1:], params, cfg)[0]


def plain_embed(torch, runner, ids: list):
    """The plain reference of ``embed_pooled``: the same forward with the
    plain attention version over the prompt alone, the final norm, the mean
    of the rows (f32)."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.ops import attention as A
    from dynamo_tpu_torch.ops.basics import rms_norm
    from dynamo_tpu_torch.ops.layers import attn_out, qkv_head

    cfg, params = runner.config, runner.params
    with torch.inference_mode():
        tokens = torch.tensor(ids, device=runner.device)
        positions = torch.arange(len(ids), device=runner.device)
        freqs = llama._rope_pair(cfg, tokens.device)
        x = llama._embed(params, cfg, tokens)
        for i, layer in enumerate(params["layers"]):
            q, k, v = qkv_head(x, layer, cfg, llama._layer_freqs(cfg, i, freqs), positions)
            attn = A.causal_prefill_attention_plain(q, k, v, len(ids))
            x = llama._mlp(attn_out(attn, x, layer, cfg), layer, cfg)
        return rms_norm(x, params["final_norm"], cfg.rms_eps).float().mean(dim=0)


def mm_media(np):
    """The phase's media: MM_IMAGES random RGB images of other sizes as PNG
    data URLs, and a clip of MM_FRAMES random frames as an animated PNG
    (each decoded by the port's stdlib reader and checked against what was
    written)."""
    from dynamo_tpu_torch.multimodal.processor import load_image_array, load_video_frames

    rng = np.random.default_rng(21)
    imgs = [rng.integers(0, 256, (280 + 24 * i, 360 + 16 * i, 3), dtype=np.uint8)
            for i in range(MM_IMAGES)]
    urls = [data_url("image/png", png_bytes(np, img)) for img in imgs]
    clip = rng.integers(0, 256, (MM_FRAMES, 120, 160, 3), dtype=np.uint8)
    video = data_url("image/apng", apng_bytes(np, clip))
    for img, url in zip(imgs, urls):
        if not np.array_equal(load_image_array(url), img):
            raise SmokeError("serve_mm: the stdlib PNG reader returned other pixels")
    if not np.array_equal(load_video_frames(video, MM_FRAMES), clip):
        raise SmokeError("serve_mm: the stdlib APNG reader returned other frames")
    return urls, video


def phase_serve_mm(torch, np, card: str, params) -> dict:
    """Multimodal serving on the card (see the docstring's phase 6b)."""
    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.multimodal.encode_worker import EncodeClient, EncodeWorker
    from dynamo_tpu_torch.multimodal.vision import ViTConfig, init_vit_params
    from dynamo_tpu_torch.multimodal.worker import MultimodalEngine
    from dynamo_tpu_torch.ops import kernels
    from dynamo_tpu_torch.protocols.common import (
        Context, FinishReason, PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    t0 = time.perf_counter()
    urls, video = mm_media(np)
    t_media = time.perf_counter() - t0
    vit = ViTConfig(**MM_VIT)
    vparams = init_vit_params(vit, torch.Generator().manual_seed(7), device="cuda")
    encoder = EncodeWorker(vparams, vit)
    engine = build_torch_engine(
        MAIN_MODEL, device="cuda", max_batch=8, max_model_len=MM_MAX_LEN, seed=0,
        fused_decode=False, spec_k=0, params=params, num_blocks=MM_BLOCKS, **EAGER)
    runner = engine.runner
    L = runner.config.num_layers
    P = vit.num_patches
    mm = MultimodalEngine(engine, encoder, placeholder_id=MM_PLACEHOLDER, num_patches=P,
                          video_frames=MM_FRAMES)
    stored: list = []
    mm.on_blocks_stored = lambda *a, **k: stored.append(a)
    t_build = time.perf_counter() - t0 - t_media
    rng = np.random.default_rng(22)
    texts = [rng.integers(0, 128000, MM_TEXT).tolist() for _ in range(MM_IMAGES + 1)]

    def req(text, extra, n=MM_OUT):
        return PreprocessedRequest(token_ids=list(text), sampling=SamplingOptions(greedy=True),
                                   stop=StopConditions(max_tokens=n), eos_token_ids=[],
                                   extra=dict(extra))

    reqs = [req(texts[i], {"mm_images": [urls[i]]}) for i in range(MM_IMAGES)]
    reqs.append(req(texts[-1], {"mm_videos": [video]}))

    async def serve():
        # a warm-up image (the tower's and the prefill's first use), then
        # the counters to 0 just before the path, read just after
        await run_requests(mm, [req(texts[0], {"mm_images": [urls[0]]}, 2)], Context)
        kernels.reset_launch_counts()
        before = stats_dict(engine.stats)
        t1 = time.perf_counter()
        out = await run_requests(mm, reqs, Context)
        wall = time.perf_counter() - t1
        launches = kernels.launch_counts()
        after = stats_dict(engine.stats)
        events = len(stored)
        # the same image alone on the device path, then on the wire path
        # (an encode worker behind an in-process fabric)
        solo = await run_requests(mm, [req(texts[0], {"mm_images": [urls[0]]})], Context)
        drt = await DistributedRuntime.detached()
        try:
            svc = await encoder.serve(drt, "mm.encoder.encode")
            client = EncodeClient(drt, "mm.encoder.encode")
            wire_mm = MultimodalEngine(engine, client, placeholder_id=MM_PLACEHOLDER,
                                       num_patches=P, video_frames=MM_FRAMES)
            t1 = time.perf_counter()
            wire = await run_requests(wire_mm, [req(texts[0], {"mm_images": [urls[0]]})], Context)
            wire_s = time.perf_counter() - t1
            await client.close()
            await svc.stop(drain=False)
        finally:
            await drt.close()
        # a text prompt on the same engine stores its blocks (the hook is live)
        await run_requests(mm, [req(rng.integers(0, 128000, 100).tolist(), {}, 4)], Context)
        return out, wall, launches, before, after, events, solo, wire, wire_s

    out, wall, launches, before, after, events, solo, wire, wire_s = asyncio.run(serve())
    for i, ((toks, reason, _), r) in enumerate(zip(out, reqs)):
        if reason is not FinishReason.LENGTH or len(toks) != MM_OUT or not all(
                0 <= t < LLAMA31_8B["vocab_size"] for t in toks):
            raise SmokeError(f"serve_mm request {i}: {len(toks)} tokens, reason {reason}")
    mm_prefills = after["mm_prefills"] - before["mm_prefills"]
    decode_steps = after["decode_steps"] - before["decode_steps"]
    want = {**dict.fromkeys(kernels.KERNELS, 0), "flash_prefill_attention": L * mm_prefills,
            "paged_decode_attention": L * decode_steps}
    if mm_prefills != len(reqs) or launches != want:
        raise SmokeError(f"serve_mm: {mm_prefills} mm prefills, launches {launches} != {want}")
    if events:
        raise SmokeError(f"serve_mm: the mm sequences emitted {events} Stored KV events")
    if not stored:
        raise SmokeError("serve_mm: a text prompt emitted no Stored event (the hook is dead)")
    if solo[0][0] != wire[0][0]:
        raise SmokeError(f"serve_mm: device-path tokens {solo[0][0]} != wire-path {wire[0][0]}")

    # the same image encoded twice; one request's prefill_mm logits
    # against the same spliced embeddings through the plain attention op
    emb = encoder.encode_device(urls[0])
    if not torch.equal(emb, encoder.encode_device(urls[0])):
        raise SmokeError("serve_mm: the same image encoded twice differs")
    ids = [MM_PLACEHOLDER] * P + texts[0]
    blocks = engine.allocator.alloc(-(-len(ids) // BLOCK))
    try:
        with torch.inference_mode():
            got = runner.prefill_mm(ids, blocks, emb, 0, 0.0, 1.0, 0, return_logits=True)
            text_only = runner.prefill_logits(ids, blocks)
            plain = dense_logits_mm(torch, runner, ids, emb)
            err = rel_logit_err(torch, got[None], plain[None])
            apart = rel_logit_err(torch, text_only[None], got[None])
            if err > MM_TOL:
                raise SmokeError(f"serve_mm: prefill_mm logits {err:.4f} of the row max from the "
                                 f"plain op's (tol {MM_TOL})")
            if apart <= MM_TOL:
                raise SmokeError(f"serve_mm: text-only logits within {apart:.4f} of the image's")
            t_encode = time_ms(torch, lambda: encoder.encode_device(urls[0]), reps=5, warmup=1)
            t_prefill = time_ms(torch, lambda: runner.prefill_mm(
                ids, blocks, emb, 0, 0.0, 1.0, 0, return_logits=True), reps=5, warmup=1)
    finally:
        engine.allocator.free(blocks)
    asyncio.run(engine.close())
    res = {
        "vit": MM_VIT, "patches": P, "requests": len(reqs), "text_tokens": MM_TEXT,
        "video_frames": MM_FRAMES, "launches": launches, "mm_prefills": mm_prefills,
        "decode_steps": decode_steps, "wall_s": wall, "ttft_s_concurrent": [t for _, _, t in out],
        "image_ttft_ms": solo[0][2] * 1e3, "wire_image_ttft_ms": wire[0][2] * 1e3,
        "wire_request_s": wire_s, "encode_ms": t_encode, "prefill_mm_ms": t_prefill,
        "prefill_mm_tokens": len(ids), "logits_rel_err": err, "text_only_rel_gap": apart,
        "media_s": t_media, "build_s": t_build,
    }
    log(f"serve_mm: {MM_IMAGES} images + a {MM_FRAMES}-frame clip (PNG / APNG by the stdlib "
        f"reader) through MultimodalEngine on the device path in {wall:.2f} s: {mm_prefills} mm "
        f"prefills, #3 {launches['flash_prefill_attention']} (= {L} x {mm_prefills}), #1 "
        f"{launches['paged_decode_attention']}; no Stored event; device = wire tokens; tower "
        f"encode {t_encode['median']:.2f} ms, prefill_mm of {len(ids)} tokens "
        f"{t_prefill['median']:.2f} ms, image TTFT {solo[0][2] * 1e3:.1f} ms (wire "
        f"{wire[0][2] * 1e3:.1f} ms); logits within {err:.4f} of the plain op's, text-only "
        f"{apart:.3f} apart ({card})")
    print(json.dumps({"serve_mm": res, "card": card}), flush=True)
    res["graph"] = mm_graph_leg(torch, np, card, urls[0])
    return res


def mm_graph_leg(torch, np, card: str, url: str) -> dict:
    """``python -m dynamo_tpu_torch.serve dynamo_tpu_torch.graphs.multimodal``
    on this card: the fabric, an encode worker with the full-size tower, a
    TorchEngine worker at Llama-3.1-8B's width and CKPT_LAYERS depth and the
    frontend, processes of their own; one streamed image chat over HTTP
    (the wire path)."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    model_dir = write_serve_dir(dict(LLAMA31_8B, num_hidden_layers=CKPT_LAYERS,
                                     max_position_embeddings=MAX_MODEL_LEN), MM_GRAPH_DIR)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
               DYN_GRAPH_ENGINE="torch", DYN_MODEL_PATH=model_dir, DYN_MODEL_NAME="mm-graph",
               DYN_DEVICE="cuda", DYN_HBM_GB=MM_GRAPH_HBM_GB, DYN_MM_VIT="clip-l-336",
               DYN_MM_OUT_DIM=str(HIDDEN), DYN_MM_PLACEHOLDER=str(MM_PLACEHOLDER))
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.serve", "dynamo_tpu_torch.graphs.multimodal",
           "--env", f"DYN_HTTP_PORT={port}", "--env", "DYN_HTTP_HOST=127.0.0.1"]
    log("serve_mm: " + " ".join(cmd[1:]))
    path = os.path.join(MM_GRAPH_DIR, "graph.log")
    t0 = time.perf_counter()
    with open(path, "w") as logf:
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=logf, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            while True:
                if proc.poll() is not None:
                    raise SmokeError(f"the multimodal graph exited with {proc.returncode} ({path})")
                try:
                    st, data = http_call(port, "GET", "/v1/models", timeout=5)
                    if st == 200 and json.loads(data)["data"]:
                        break
                except (OSError, ValueError):
                    pass
                if time.perf_counter() - t0 > SERVER_START_S:
                    raise SmokeError(f"the multimodal graph did not come up ({path})")
                time.sleep(0.5)
            up_s = time.perf_counter() - t0
            body = {"model": "mm-graph", "max_tokens": 8, "temperature": 0, "stream": True,
                    "stream_options": {"include_usage": True}, "nvext": {"ignore_eos": True},
                    "messages": [{"role": "user", "content": [
                        {"type": "image_url", "image_url": {"url": url}},
                        {"type": "text", "text": "describe the picture"}]}]}
            got = stream_chat(port, body)
            if got["usage"]["completion_tokens"] != 8 or got["usage"]["prompt_tokens"] <= 0:
                raise SmokeError(f"serve_mm graph: usage {got['usage']}")
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)
    res = {"up_s": up_s, "ttft_s": got["ttft_s"], "usage": got["usage"]}
    log(f"serve_mm: the multimodal graph came up in {up_s:.1f} s; a streamed image chat over "
        f"HTTP (the wire path) in TTFT {got['ttft_s'] * 1e3:.1f} ms, usage {got['usage']} ({card})")
    return res


PREBAKE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "prebake_model")


def phase_prebake(card: str) -> dict:
    """tools/prebake.py against this script's kernel directory, as an
    operator runs it: ``--model-path`` on a Llama-3.1-8B-width directory at
    ``MAIN_LAYERS`` depth (seeded random weights) with serve's shapes --
    ``max_batch`` 8, ``max_model_len`` 4096 (every prefill bucket), the
    HTTP server's pool of 2112 blocks, decode horizon 4 -- and spec_k 3.
    Every library must be found built (nvcc run 0 times), every dispatch
    driven on the card, its decode graphs captured and listed in the
    manifest."""
    root = os.path.dirname(os.path.abspath(__file__))
    out_json = os.path.join(root, "build", "prebake.json")
    model_dir = write_serve_dir(MAIN_MODEL, PREBAKE_DIR)
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("DYN_KERNEL_CACHE_DIR", None)
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.tools.prebake", "--model-path", model_dir,
           "--device", "cuda", "--max-batch", "8", "--context-length", str(MAX_MODEL_LEN),
           "--num-blocks", "2112", "--decode-horizon", "4", "--spec-k", "3", "--json", out_json]
    log("prebake: " + " ".join(cmd[1:]))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SmokeError(f"prebake exited {proc.returncode}: {proc.stderr[-3000:]}")
    with open(out_json) as f:
        doc = json.load(f)
    k = doc["kernels"]
    libs = k.get("libraries", {})
    if not k.get("built") or k.get("nvcc_runs") != 0 or not libs or not all(
            v["cache_hit"] for v in libs.values()):
        raise SmokeError(f"prebake: the libraries were not all cache hits: {k}")
    with open(doc["manifest"]) as f:
        manifest = json.load(f)
    if not doc["graphs"] or manifest.get("graphs") != doc["graphs"]:
        raise SmokeError(f"prebake: graphs {doc['graphs']}, manifest {manifest.get('graphs')}")
    res = {"wall_s": wall, "tool_wall_s": doc["wall_s"], "total_s": doc["total_s"],
           "libraries": libs, "graphs": doc["graphs"], "programs": doc["programs"],
           "labels": manifest["labels"], "model": f"Llama-3.1-8B width, {MAIN_LAYERS} layers"}
    log(f"prebake (Llama-3.1-8B width, {MAIN_LAYERS} layers, {len(doc['programs'])} programs in "
        f"{doc['total_s']:.1f} s): {len(libs)} libraries, every one a cache hit, nvcc run 0 times; "
        f"{len(doc['graphs'])} graphs captured ({', '.join(doc['graphs'])}); manifest labels "
        f"{manifest['labels']}; wall {wall:.1f} s (the tool's own {doc['wall_s']:.1f} s) ({card})")
    print(json.dumps({"prebake": res, "card": card}), flush=True)
    return res


# The GGUF leg of the checkpoint phase: a 2-layer, full-width Llama-3.1-8B
# .gguf written by the script's own writer into an HF-cache-shaped directory,
# resolved by repo id through DYN_MODEL_CACHE and loaded by build_torch_engine.
GGUF_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_hf_cache")
GGUF_REPO = "chip-smoke/llama31-8b-2l-gguf"
GGML_F32, GGML_F16, GGML_Q8_0 = 0, 1, 8
GGUF_U32, GGUF_F32, GGUF_STRING, GGUF_ARRAY = 4, 6, 8, 9


def _gguf_str(s: str) -> bytes:
    import struct

    b = s.encode()
    return struct.pack("<Q", len(b)) + b


def _gguf_value(vtype: int, value) -> bytes:
    import struct

    if vtype == GGUF_STRING:
        return _gguf_str(value)
    if vtype == GGUF_U32:
        return struct.pack("<I", value)
    if vtype == GGUF_F32:
        return struct.pack("<f", value)
    etype, items = value  # an array
    return struct.pack("<IQ", etype, len(items)) + b"".join(_gguf_value(etype, x) for x in items)


def write_gguf(path: str, metadata: dict, tensors: dict, align: int = 32) -> int:
    """A GGUF v3 file: ``metadata`` {key: (type, value)}, ``tensors`` {name:
    (ggml type, numpy shape [out, in], raw bytes)}. Returns its size."""
    import struct

    head = [struct.pack("<IIQQ", 0x46554747, 3, len(tensors), len(metadata))]
    head += [_gguf_str(k) + struct.pack("<I", t) + _gguf_value(t, v) for k, (t, v) in metadata.items()]
    offset = 0
    offsets = []
    for name, (gt, shape, raw) in tensors.items():
        offset = (offset + align - 1) // align * align
        dims = list(reversed(shape))  # ggml order: the fastest-varying first
        head.append(_gguf_str(name) + struct.pack("<I", len(dims))
                    + b"".join(struct.pack("<Q", d) for d in dims) + struct.pack("<IQ", gt, offset))
        offsets.append(offset)
        offset += len(raw)
    head = b"".join(head)
    start = (len(head) + align - 1) // align * align
    with open(path, "wb") as f:
        f.write(head + b"\0" * (start - len(head)))
        for off, (_, _, raw) in zip(offsets, tensors.values()):
            f.seek(start + off)
            f.write(raw)
    return start + offset


def q8_0(torch, np, w):
    """Q8_0 blocks of 32 (an f16 scale, then 32 int8) of a card tensor
    [out, in]: the file's bytes, and the script's own dequantization of them
    (f32, [out, in])."""
    flat = w.float().reshape(-1, 32)
    d = (flat.abs().amax(dim=1) / 127.0).clamp_min(1e-8).half()
    q = torch.round(flat / d.float()[:, None]).clamp(-127, 127).to(torch.int8)
    rec = np.zeros(flat.shape[0], dtype=np.dtype([("d", "<f2"), ("q", "i1", (32,))]))
    rec["d"] = d.cpu().numpy()
    rec["q"] = q.cpu().numpy()
    return rec.tobytes(), (q.float() * d.float()[:, None]).reshape(w.shape)


def gguf_leg(torch, np, card: str) -> dict:
    """The GGUF leg (see the docstring's phase 7): F16 embeddings and
    output, F32 norms, Q8_0 attention projections, F16 MLP, llama
    SentencePiece tokenizer metadata; the loaded weights bit for bit the
    script's own dequantization in bf16, greedy tokens equal params='s."""
    import shutil

    from dynamo_tpu_torch.engine.torch_engine.factory import build_torch_engine
    from dynamo_tpu_torch.hub import resolve_model
    from dynamo_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.protocols.common import (
        Context, PreprocessedRequest, SamplingOptions, StopConditions,
    )

    c = LLAMA31_8B
    V, H, F, Lg = c["vocab_size"], c["hidden_size"], c["intermediate_size"], CKPT_LAYERS
    hd = H // c["num_attention_heads"]
    kv = c["num_key_value_heads"] * hd
    cfg = LlamaConfig(vocab_size=V, hidden_size=H, intermediate_size=F, num_layers=Lg,
                      num_heads=c["num_attention_heads"], num_kv_heads=c["num_key_value_heads"],
                      head_dim=hd, rope_theta=c["rope_theta"], rms_eps=c["rms_norm_eps"],
                      max_position_embeddings=MAX_MODEL_LEN)
    gen = torch.Generator(device="cuda").manual_seed(8)

    def randn(*shape, scale):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    tensors, want = {}, {"layers": [dict() for _ in range(Lg)]}

    def f16(name, w, ours, layer=None, transpose=False):
        h = w.half()
        tensors[name] = (GGML_F16, tuple(h.shape), h.cpu().numpy().tobytes())
        v = h.float().t() if transpose else h.float()
        (want if layer is None else want["layers"][layer])[ours] = v.contiguous().to(torch.bfloat16)

    def f32(name, w, ours, layer=None):
        tensors[name] = (GGML_F32, tuple(w.shape), w.float().cpu().numpy().tobytes())
        (want if layer is None else want["layers"][layer])[ours] = w.float().to(torch.bfloat16)

    def q8(name, w, ours, layer):
        raw, deq = q8_0(torch, np, w)
        tensors[name] = (GGML_Q8_0, tuple(w.shape), raw)
        want["layers"][layer][ours] = deq.t().contiguous().to(torch.bfloat16)

    f16("token_embd.weight", randn(V, H, scale=0.02), "embed")
    f32("output_norm.weight", 1 + randn(H, scale=0.1), "final_norm")
    f16("output.weight", randn(V, H, scale=H ** -0.5), "lm_head", transpose=True)
    for i in range(Lg):
        b = f"blk.{i}."
        f32(b + "attn_norm.weight", 1 + randn(H, scale=0.1), "attn_norm", i)
        f32(b + "ffn_norm.weight", 1 + randn(H, scale=0.1), "mlp_norm", i)
        for name, ours, out_dim in (("attn_q", "wq", H), ("attn_k", "wk", kv), ("attn_v", "wv", kv)):
            q8(b + name + ".weight", randn(out_dim, H, scale=H ** -0.5), ours, i)
        q8(b + "attn_output.weight", randn(H, H, scale=H ** -0.5), "wo", i)
        f16(b + "ffn_gate.weight", randn(F, H, scale=H ** -0.5), "wg", i, transpose=True)
        f16(b + "ffn_up.weight", randn(F, H, scale=H ** -0.5), "wu", i, transpose=True)
        f16(b + "ffn_down.weight", randn(H, F, scale=F ** -0.5), "wd", i, transpose=True)
    n = V - 3
    metadata = {
        "general.architecture": (GGUF_STRING, "llama"),
        "llama.embedding_length": (GGUF_U32, H), "llama.feed_forward_length": (GGUF_U32, F),
        "llama.block_count": (GGUF_U32, Lg),
        "llama.attention.head_count": (GGUF_U32, cfg.num_heads),
        "llama.attention.head_count_kv": (GGUF_U32, cfg.num_kv_heads),
        "llama.attention.key_length": (GGUF_U32, hd),
        "llama.context_length": (GGUF_U32, MAX_MODEL_LEN), "llama.vocab_size": (GGUF_U32, V),
        "llama.rope.freq_base": (GGUF_F32, cfg.rope_theta),
        "llama.attention.layer_norm_rms_epsilon": (GGUF_F32, cfg.rms_eps),
        "tokenizer.ggml.model": (GGUF_STRING, "llama"),
        "tokenizer.ggml.tokens": (GGUF_ARRAY, (GGUF_STRING, ["<unk>", "<s>", "</s>"]
                                               + [f"▁w{i}" for i in range(n)])),
        "tokenizer.ggml.scores": (GGUF_ARRAY, (GGUF_F32, [0.0] * 3 + [-i / 1e4 for i in range(n)])),
        "tokenizer.ggml.token_type": (GGUF_ARRAY, (GGUF_U32, [2, 3, 3] + [1] * n)),
        "tokenizer.ggml.unknown_token_id": (GGUF_U32, 0),
        "tokenizer.ggml.bos_token_id": (GGUF_U32, 1),
        "tokenizer.ggml.eos_token_id": (GGUF_U32, 2),
    }
    snap = os.path.join(GGUF_CACHE, "models--" + GGUF_REPO.replace("/", "--"), "snapshots", "r1")
    shutil.rmtree(GGUF_CACHE, ignore_errors=True)
    os.makedirs(snap)
    prev = os.environ.get("DYN_MODEL_CACHE")
    os.environ["DYN_MODEL_CACHE"] = GGUF_CACHE
    try:
        t0 = time.perf_counter()
        nbytes = write_gguf(os.path.join(snap, "llama31-8b-2l-q8_0.gguf"), metadata, tensors)
        del tensors
        t_write = time.perf_counter() - t0
        path = resolve_model(GGUF_REPO)
        if not path.endswith(".gguf"):
            raise SmokeError(f"gguf: {GGUF_REPO} resolved to {path}")
        t0 = time.perf_counter()
        loaded = build_torch_engine(GGUF_REPO, device="cuda", max_batch=4, max_model_len=1024)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        mdc = ModelDeploymentCard.from_model_path(path, kv_block_size=BLOCK)
        t_card = time.perf_counter() - t0
    finally:
        if prev is None:
            os.environ.pop("DYN_MODEL_CACHE", None)
        else:
            os.environ["DYN_MODEL_CACHE"] = prev
        shutil.rmtree(GGUF_CACHE, ignore_errors=True)
    got_cfg = loaded.runner.config
    for k in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
              "num_kv_heads", "head_dim", "rope_theta", "max_position_embeddings"):
        if getattr(got_cfg, k) != getattr(cfg, k):
            raise SmokeError(f"gguf: config {k} {getattr(got_cfg, k)} != {getattr(cfg, k)}")
    a = {k: v for k, v in loaded.runner.params.items() if k != "layers"}
    bad = [k for k in want if k != "layers" and not torch.equal(a[k].view(torch.int16),
                                                                  want[k].view(torch.int16))]
    for i, layer in enumerate(want["layers"]):
        got_l = loaded.runner.params["layers"][i]
        bad += [f"{i}/{k}" for k, v in layer.items() if got_l[k].dtype != torch.bfloat16
                or not torch.equal(got_l[k].view(torch.int16), v.view(torch.int16))]
        if sorted(got_l) != sorted(layer):
            bad.append(f"{i}: keys {sorted(got_l)}")
    if bad or sorted(a) != sorted(k for k in want if k != "layers"):
        raise SmokeError(f"gguf: loaded weights differ from the dequantized ones: {bad[:8]}")
    tok = mdc.load_tokenizer()
    ids = tok.encode("w1 w2 w300", add_special_tokens=False).ids
    if mdc.tokenizer_kind != "sp" or tok.decode(ids) != "w1 w2 w300":
        raise SmokeError(f"gguf: the embedded tokenizer gave {ids} -> {tok.decode(ids)!r}")
    same = build_torch_engine(cfg, device="cuda", max_batch=4, max_model_len=1024, params=want)
    rng = np.random.default_rng(10)
    reqs = [PreprocessedRequest(token_ids=rng.integers(0, V, n).tolist(),
                                sampling=SamplingOptions(greedy=True),
                                stop=StopConditions(max_tokens=m), eos_token_ids=[])
            for n, m in CKPT_PROMPTS]

    async def serve(engine):
        try:
            return await run_requests(engine, reqs, Context)
        finally:
            await engine.close()

    got = asyncio.run(serve(loaded))
    ref = asyncio.run(serve(same))
    if [t for t, _, _ in got] != [t for t, _, _ in ref]:
        raise SmokeError("gguf: the loaded engine's tokens differ from params='s")
    if [len(t) for t, _, _ in got] != [m for _, m in CKPT_PROMPTS]:
        raise SmokeError("gguf: wrong token counts")
    res = {"layers": Lg, "bytes": nbytes, "write_s": t_write, "load_s": t_load, "card_s": t_card,
           "repo": GGUF_REPO, "types": "F16 embed/output/MLP, F32 norms, Q8_0 attention"}
    log(f"checkpoint/gguf: {nbytes / 1e9:.2f} GB .gguf written in {t_write:.1f} s; {GGUF_REPO} "
        f"resolved through DYN_MODEL_CACHE and loaded by build_torch_engine in {t_load:.1f} s "
        f"(its card with the embedded {V}-piece tokenizer in {t_card:.1f} s); weights "
        f"bit-identical to the script's dequantization; greedy tokens equal params= ({card})")
    print(json.dumps({"checkpoint_gguf": res, "card": card}), flush=True)
    return res


def serve_tp_mm(torch, np, card: str, one, engine) -> dict:
    """serve_tp's bf16 leg, its mm / embed part (both engines open, before
    the spec leg, whose close stops the followers): an image's prefill_mm
    logits (OP_MM_PREFILL) and a pooled embedding (OP_EMBED) on the tp = 2
    group against the one-card engine's, within TP_LOGIT_TOL; each rank's
    #3 launched once a layer per call."""
    from dynamo_tpu_torch.multimodal.encode_worker import EncodeWorker
    from dynamo_tpu_torch.multimodal.vision import ViTConfig, init_vit_params

    vit = ViTConfig(**MM_VIT)
    encoder = EncodeWorker(init_vit_params(vit, torch.Generator().manual_seed(7), device="cuda"), vit)
    rng = np.random.default_rng(23)
    url = data_url("image/png", png_bytes(np, rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)))
    text = rng.integers(0, 128000, MM_TEXT).tolist()
    ids = [MM_PLACEHOLDER] * vit.num_patches + text
    emb = encoder.encode_device(url)
    runner = engine.runner
    n_blocks = -(-len(ids) // BLOCK)
    blocks = {e: e.allocator.alloc(n_blocks) for e in (one, engine)}
    try:
        # one card first: the leader's counters are this process's
        want = one.runner.prefill_mm(ids, blocks[one], emb, 0, 0.0, 1.0, 0, return_logits=True)
        e_want = torch.from_numpy(one.runner.embed(text))
        runner.rank_stats(reset=True)
        t0 = time.perf_counter()
        got = runner.prefill_mm(ids, blocks[engine], emb, 0, 0.0, 1.0, 0, return_logits=True)
        e_got = torch.from_numpy(runner.embed(text))
        group_s = time.perf_counter() - t0
        ranks = runner.rank_stats()
    finally:
        for e, b in blocks.items():
            e.allocator.free(b)
    err = rel_logit_err(torch, got[None].float(), want[None].float())
    e_err = float((e_got - e_want).abs().max() / e_want.abs().max())
    if err > TP_LOGIT_TOL or not (e_err <= TP_LOGIT_TOL) or not torch.isfinite(e_got).all():
        raise SmokeError(f"serve_tp/mm: prefill_mm logits {err:.4f}, embedding {e_err:.4f} of the "
                         f"one-card engine's (tol {TP_LOGIT_TOL})")
    L = TP_MODEL["num_hidden_layers"]
    for r, st in enumerate(ranks):
        if st["launches"]["flash_prefill_attention"] != 2 * L:  # one mm prefill, one embed
            raise SmokeError(f"serve_tp/mm rank {r}: #3 launched {st['launches']}")
    res = {"logits_rel_err": err, "embed_rel_err": e_err, "group_s": group_s,
           "rank_prefill_launches": [st["launches"]["flash_prefill_attention"] for st in ranks]}
    log(f"serve_tp/mm: over OP_MM_PREFILL the group's prefill_mm logits ({len(ids)} rows, "
        f"{vit.num_patches} of them an image's) are within {err:.4f} of the row max of one "
        f"card's, over OP_EMBED its embedding within {e_err:.4f} ({group_s:.2f} s for both); #3 "
        f"{res['rank_prefill_launches']} a rank (= 2 x {L}) ({card})")
    return res


def main() -> int:
    if "--cp-node" in sys.argv:  # node 1 of serve_tp's CP leg, started by that leg
        return cp_node_main()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.environ[RUN_MARK] = f"{os.getpid()}-{time.time_ns()}"
    try:
        from dynamo_tpu_torch.ops import _build
    except ImportError as e:
        print(f"[chip_smoke] FAIL: the port's package is not beside this "
              f"script: {e}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # ``--only serve_offload`` / ``serve_fabric`` / ``serve_kv`` / ``serve_tp``
    # / ``serve_disagg_fabric`` / ``serve_trace_faults`` / ``serve_peer`` /
    # ``serve_ops``: the
    # device, the build and that phase alone (a quicker call while the phase is worked on; no
    # kernels line)
    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv else None
    t_lap = [time.perf_counter()]

    def lap(name: str) -> None:
        """Each phase's wall time, so a later phase can be sized to the
        script's time limit."""
        now = time.perf_counter()
        log(f"time: {name} {now - t_lap[0]:.1f} s (script {now - t_start:.1f} s)")
        t_lap[0] = now

    t_start = t_lap[0]
    try:
        # 1. device
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        card = nvidia_smi_line()
        log(f"device: {kind} x{count}; nvidia-smi: {card}")
        log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

        # 2. build
        t0 = time.perf_counter()
        info = _build.build_all()
        lap("build")
        log(f"build: {len(info)} kernels in {time.perf_counter() - t0:.1f} s")
        for name, row in info.items():
            log(f"build {name}: {row['seconds']:.1f} s")
            for line in row["ptxas"].splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")
        if only in ("serve_offload", "serve_fabric", "serve_kv", "serve_tp", "serve_disagg_fabric",
                    "serve_trace_faults", "serve_peer", "serve_ops", "serve_moe", "serve_mm",
                    "checkpoint", "serve_http", "prebake"):
            if only == "serve_mm":
                from dynamo_tpu_torch.engine.torch_engine.weights import init_params
                from dynamo_tpu_torch.models.llama import LlamaConfig

                phase_serve_mm(torch, np, card, init_params(
                    LlamaConfig.from_hf_dict(MAIN_MODEL), seed=0, device="cuda"))
            elif only == "checkpoint":
                phase_checkpoint(torch, np, card)
            elif only == "serve_http":
                phase_serve_http(torch, np, card)
            elif only == "prebake":
                phase_prebake(card)
            elif only == "serve_offload":
                phase_serve_offload(torch, np, card, *offload_params(torch))
            elif only == "serve_fabric":
                phase_serve_fabric(torch, np, card)
            elif only == "serve_tp":
                phase_serve_tp(torch, np, card)
            elif only == "serve_disagg_fabric":
                phase_serve_disagg_fabric(torch, np, card)
            elif only == "serve_trace_faults":
                phase_serve_trace_faults(torch, np, card)
            elif only == "serve_peer":
                phase_serve_peer(torch, np, card, peer_params(torch))
            elif only == "serve_ops":
                phase_serve_ops(torch, np, card)
            elif only == "serve_moe":
                phase_serve_moe(torch, np, card)
            else:
                phase_serve_kv(torch, np, card)
            return finish_run([card, json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": kind, "count": count}})])
        if only is not None:
            raise SmokeError(f"--only takes serve_offload, serve_fabric, serve_kv, serve_tp, "
                             f"serve_disagg_fabric, serve_trace_faults, serve_peer, serve_ops, "
                             f"serve_moe, serve_mm, checkpoint, serve_http or prebake, not {only}")

        # 2b. prebake: the tool against this script's kernel directory
        phase_prebake(card)
        lap("prebake")

        # 3. parity; the parallel forms' parity on two rank processes of
        # their own meanwhile (their start-up overlaps the kernel checks)
        with ThreadPoolExecutor(1) as pool:
            parallel = pool.submit(parallel_parity, torch, np)
            errs = phase_parity(torch)
            errs.update(phase_parity_int8(torch))
            errs.update(phase_parity_tp(torch))
            print(json.dumps({"parity_tp_parallel": parallel.result()}), flush=True)
        lap("parity")

        # 4. serve and 5. serve_spec (each path's counters set to 0 just
        # before it, read just after)
        served = phase_serve(torch, np, card)
        engine = served.pop("engine")
        lap("serve")
        spec = phase_serve_spec(torch, np, card, engine.runner.params)
        fused_runner = spec.pop("runner")
        spec_reqs = spec.pop("reqs")
        lap("serve_spec")
        # 6. serve_default (its counters set to 0 just before it, read just
        # after) and 7. checkpoint
        default = phase_serve_default(torch, np, card, engine.runner.params)
        default_engine = default.pop("engine")
        lap("serve_default")
        # 6b. serve_mm: multimodal serving over the same weights (its
        # counters set to 0 just before its traffic, read just after), then
        # the multimodal graph over HTTP
        mm = phase_serve_mm(torch, np, card, engine.runner.params)
        lap("serve_mm")
        phase_checkpoint(torch, np, card)
        lap("checkpoint")
        # 9. serve_int8 (each of its two runs' counters set to 0 just before
        # it, read just after)
        int8 = phase_serve_int8(torch, np, card, engine.runner.num_blocks,
                                served["engine_peak_mem_bytes"])
        int8_runner = int8.pop("runner")
        lap("serve_int8")
        # each kernel's launches on the path that owns it: decode (#1) on
        # the default path, prefill (#3) on the chunking-off serve path, the
        # other three on the spec path, the int8 modes on serve_int8's two
        # runs (default path, then spec)
        launches = {
            **served["launches"],
            **{k: spec["launches"][k] for k in SPEC_KERNELS},
            "paged_decode_attention": default["launches"]["paged_decode_attention"],
            **{k: int8["launches_both"][k] for k in INT8_KERNELS},
        }

        # 8. times (each part's wall time logged)
        t_part = [time.perf_counter()]

        def part(name: str) -> None:
            now = time.perf_counter()
            log(f"time: times/{name} {now - t_part[0]:.1f} s")
            t_part[0] = now

        phase_engine_times(torch, np, engine, fused_runner, card)
        part("engine")
        admission_times(torch, np, default_engine, card)
        part("admission")
        int8_engine_times(torch, np, int8_runner, fused_runner, default_engine.runner, card)
        part("int8_engine")
        rows = phase_kernel_times(torch, card)
        part("kernels")
        rows.update(phase_kernel_times_int8(torch, card))
        part("kernels_int8")
        rows.update(tp_partial_times(torch, card))
        part("tp_partial")
        log(f"peak device memory during serve: {served['peak_mem_bytes'] / 1e9:.2f} GB")
        lap("times")

        # 12. serve_horizon: build_torch_engine's defaults (H = 4 on CUDA
        # graphs) beside eager runs of the same runners; each run's counters
        # set to 0 just before it, read just after. Its runs own #1 (the
        # default path), #2, #4 and #5 (spec with the chained horizon) and
        # #1q, #4q, #5q (the int8 deployment), counted through replays.
        horizon = phase_serve_horizon(torch, np, card, engine.runner.params, fused_runner,
                                      int8_runner, spec_reqs)
        launches["paged_decode_attention"] = horizon["launches"]["paged_decode_attention"]
        launches.update({k: horizon["spec_launches_e3"][k] for k in SPEC_KERNELS})
        launches.update({k: horizon["int8_launches"][k] for k in INT8_KERNELS
                         if k != "paged_verify_attention_int8"})
        lap("serve_horizon")

        # 14. serve_disagg: a decode engine and a prefill engine from
        # build_torch_engine's defaults on this card, every shipped prompt
        # prefilled by #3 on the prefill engine (each leg's counters set to 0
        # just before it, read just after); #3's row adds the launches of the
        # two legs whose prefill engine runs the single-shot prefill (the
        # device path's and the monolithic host path's last runs) to serve's
        disagg = phase_serve_disagg(torch, np, card, engine.runner.params, int8_runner.params)
        from_disagg = {leg: disagg["launches"][leg][-1]["flash_prefill_attention"]
                       for leg in ("device_bf16", "host_monolithic")}
        log(f"flash_prefill_attention launches: serve {launches['flash_prefill_attention']}, "
            f"serve_disagg {from_disagg}")
        launches["flash_prefill_attention"] += sum(from_disagg.values())
        # serve_mm's multimodal prefills, each a single-shot #3 prefill
        log(f"flash_prefill_attention launches: serve_mm {mm['launches']['flash_prefill_attention']}")
        launches["flash_prefill_attention"] += mm["launches"]["flash_prefill_attention"]
        lap("serve_disagg")

        # 15. serve_offload: the tiered block manager (each leg's counters
        # set to 0 just before it, read just after)
        # (at the full 32 layers: their tiers are sized in GiB of its blocks)
        full = offload_params(torch)
        phase_serve_offload(torch, np, card, *full)
        lap("serve_offload")
        # 20. serve_peer: the peer tier over a fabric server process, the KV
        # router's pull plan, class-aware preemption and the native hash
        phase_serve_peer(torch, np, card, full[0])
        del full
        lap("serve_peer")

        # 10. serve_http: the CLI's HTTP server in a process of its own, so
        # this process's engines leave the card first
        del engine, default_engine, fused_runner, spec, served, default, int8_runner, int8
        del horizon, spec_reqs, disagg, mm
        gc.collect()
        torch.cuda.empty_cache()
        # 11. serve_tp: two ranks on this card over gloo, then one over
        # NCCL (every rank's counters set to 0 just before each leg's
        # requests, read just after)
        tp = phase_serve_tp(torch, np, card)
        launches.update({k: tp["legs"][w]["launches_summed"][k]
                         for k, w in zip(TP_KERNELS, ("bf16", "int8"))})
        for k in TP_KERNELS:  # the B=8 step's row of Llama-3.1-8B tp=2's shard
            rows[k] = rows[f"{k}/llama31_8b_tp2/M8"]
        lap("serve_tp")
        gc.collect()
        torch.cuda.empty_cache()
        # 13. serve_moe: Mixtral-8x7B's width at 16 layers on the card freed
        # by the phases before (its counters set to 0 just before each of
        # its two serve runs, read just after; the grouped kernel launched by
        # replays and by the eager prefills)
        log(f"device memory held before serve_moe: {torch.cuda.memory_allocated() / 1e9:.2f} GB")
        moe = phase_serve_moe(torch, np, card)
        launches[MOE_KERNEL] = moe["launches"][MOE_KERNEL]
        errs.update(moe.pop("errs"))
        rows.update(moe.pop("rows"))
        del moe
        lap("serve_moe")
        gc.collect()
        torch.cuda.empty_cache()
        log(f"device memory held before the server starts: {torch.cuda.memory_allocated() / 1e9:.2f} GB")
        http = phase_serve_http(torch, np, card)
        lap("serve_http")
        # 16. serve_fabric: the fabric server, two workers and an out=dyn
        # frontend, processes of their own on this card
        phase_serve_fabric(torch, np, card, http["http_lone"]["text"])
        lap("serve_fabric")
        # 17. serve_kv: KV-aware routing over two workers with host tiers, the
        # standalone router and the agg graph (each worker's #1 counted)
        phase_serve_kv(torch, np, card)
        lap("serve_kv")
        # 18. serve_disagg_fabric: the disagg graph across processes (each
        # worker's counters read just before and just after its traffic);
        # #3's row adds its prefill workers' launches
        gc.collect()
        torch.cuda.empty_cache()
        log(f"device memory held before serve_disagg_fabric: {torch.cuda.memory_allocated() / 1e9:.2f} GB")
        fab = phase_serve_disagg_fabric(torch, np, card, [c["text"] for c in http["concurrent"]])
        log(f"flash_prefill_attention launches: serve_disagg_fabric's prefill workers "
            f"{fab['launches']['flash_prefill_attention']}")
        launches["flash_prefill_attention"] += fab["launches"]["flash_prefill_attention"]
        lap("serve_disagg_fabric")
        # 19. serve_trace_faults: a traced fleet, a worker killed by
        # DYN_FAULT, a traced disagg graph under corrupt_kv, then in this
        # process slow_decode, abort_after_tokens and tracing on / off
        del fab
        gc.collect()
        torch.cuda.empty_cache()
        phase_serve_trace_faults(torch, np, card)
        lap("serve_trace_faults")
        # 21. serve_ops: the operating plane (metrics, admission, the SLO
        # plane and brownout, hedging and ejection, tools) across processes
        gc.collect()
        torch.cuda.empty_cache()
        phase_serve_ops(torch, np, card)
        lap("serve_ops")
    except Exception as e:  # noqa: BLE001 - report and fail the run
        import traceback

        traceback.print_exc()
        print(f"[chip_smoke] FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        stop_run_processes()
        return 1

    # the int8 modes replace the same Pallas kernels' int8 branches
    replaces = {
        "paged_decode_attention": "dynamo_tpu/ops/pallas_attention.py:231",
        "flash_prefill_attention": "dynamo_tpu/ops/pallas_attention.py:554",
        "paged_verify_attention": "dynamo_tpu/ops/pallas_attention.py:452",
        "fused_qkv_rope": "dynamo_tpu/ops/linear.py:206",
        "fused_attn_out_residual": "dynamo_tpu/ops/linear.py:334",
        "paged_decode_attention_int8": "dynamo_tpu/ops/pallas_attention.py:231",
        "paged_verify_attention_int8": "dynamo_tpu/ops/pallas_attention.py:452",
        "fused_qkv_rope_int8": "dynamo_tpu/ops/linear.py:206",
        "fused_attn_out_residual_int8": "dynamo_tpu/ops/linear.py:334",
        # the partial_out branch of the same Pallas program (linear.py:321-325)
        "fused_attn_out_partial": "dynamo_tpu/ops/linear.py:334",
        "fused_attn_out_partial_int8": "dynamo_tpu/ops/linear.py:334",
        # no Pallas kernel upstream: the dropless MoE FFN's grouped products
        MOE_KERNEL: "dynamo_tpu/ops/moe.py:111 (_grouped_ffn, lax.ragged_dot: XLA, no pallas_call)",
    }
    from dynamo_tpu_torch.ops.kernels import SOURCES

    kernels = []
    for name, replaced in replaces.items():
        # the fused heads' row is at the verify step's shape (M = 32)
        row = rows.get(name) or rows[f"{name}/M32"]
        kernels.append({
            "name": name, "route": "cuda", "source": f"dynamo_tpu_torch/csrc/{SOURCES[name][0]}.cu",
            "replaces": replaced, "launches": launches[name],
            "max_abs_err": errs[name], "ms": row["ms"]["median"],
            "plain_ms": row["plain_ms"]["median"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]["median"] if "library_ms" in row else None,
        })
    return finish_run([card, json.dumps({"kernels": kernels}), json.dumps(
        {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})])


if __name__ == "__main__":
    sys.exit(main())
