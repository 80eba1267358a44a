#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (bitblas_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout
    python3 chip_smoke.py --bitnet-readings   # only the readings that
                                              # BITNET_LOGIT_* are set from
    python3 chip_smoke.py --bitnet-tuned-ab   # only serve_bitnet against
                                              # serve_bitnet_tuned, in turns
    python3 chip_smoke.py --formats           # only the formats phase
    python3 chip_smoke.py --int-formats       # only the int_formats phase
    python3 chip_smoke.py --ops               # only the ops phase (Conv2D,
                                              # QuantConv2D, split-K,
                                              # BatchMatmul, the permutes)
    python3 chip_smoke.py --mistral           # only the Mistral-7B-v0.1
                                              # phases (bf16, the window)
    python3 chip_smoke.py --bitnet-3b         # only flashatten and the
                                              # BitNet b1.58-3B phases
    python3 chip_smoke.py --bitnet-3b-readings  # the readings the 3B
                                              # reference's limits rest on
    python3 chip_smoke.py --mixtral           # only the Mixtral-8x7B
                                              # phases (the routed MoE FFN)
    python3 chip_smoke.py --quantize          # only the model tools'
                                              # phases (GPTQ / RTN from
                                              # float weights, speculation,
                                              # BitNet's QAT forward)
    python3 chip_smoke.py --parallel          # only the multi-GPU phases
                                              # (TP / EP / pipeline / cp,
                                              # the DP router)
    python3 chip_smoke.py --danube            # only the slice-19 phases
                                              # (kernel 4's d80 and general
                                              # instances, kernels 5-8 at
                                              # D = 512, H2O-Danube-1.8B)

Phases, one JSON line each (a failure in any phase raises and exits
non-zero; on a host without CUDA it exits 2 and prints no result):

1. env      -- card name and power limit (nvidia-smi), torch and CUDA versions.
2. build    -- nvcc builds csrc/*.cu, one process per source, all at once.
2b. parallel -- (after the ops phase) kernels 1 / 2 / 4 / 5 at serve_tp's
               rank-local shapes (Llama-3-70B at tp 2) and kernels 5 / 6
               in partial_stats mode over two sequence shards (against
               their plain versions; the shards' log-sum-exp merge against
               the unsplit kernel); then one world of two gloo ranks on
               the card: the collective probe, serve_tp (16 layers of
               Llama-3-70B, four token requests, held to the single-device
               model in f16 ulps, 32 all-reduces a decode step, the
               ranks' tokens equal), tp_options (int8 collectives,
               overlap_chunks, the int8 cache, paged against slot,
               context parallelism through the partial_stats kernels) and
               ep_mixtral (2 Mixtral-8x7B layers, 4 experts a rank); then
               this process as a one-rank NCCL group (tp_nccl, pipeline at
               pp 1) and dp_group (two replica engines behind the router).
               `--parallel` alone.
3. kernels  -- each kernel against its plain PyTorch version on the card at
               the slice's shapes: max abs / relative error, kernel_ms,
               plain_ms, library_ms (a PyTorch call computing the same
               function, timed as a yardstick only; null where none does)
               and bound_ms (the larger of bytes over 3.35 TB/s and
               operations over 989 TFLOP/s f16, 1979 TOP/s int8 or 67
               TFLOP/s float32 FFMA, the H100 SXM data-sheet peaks); the
               paged kernels also time the table-gather path (gather_ms);
               flash_attention_fwd (S = 512) and flash_decode also run at
               BitNet's heads (H = 32, Hkv = 8); the attention rows time
               a contiguous read of the same bytes (stream_ms).
               Kernel 1 runs at M = 1 / 4 / 16 (the split-K decode
               instance of each format; int2 on BitNet's four projection
               shapes, beside the 32 x 64 wgmma tile on the same operands,
               tile_32x64_ms) and 32 / 64 / 128 / 256 / 512 (the wgmma +
               TMA tiled instance of the default route, both formats); the
               rows of kernels 1, 2, 3 and 9 time a contiguous read of
               their bytes too (stream_ms). Kernel 1 again at GPTQ's
               group sizes 32, 64 and per channel (both MLP shapes), zeros
               mode rescale and a bias (g = 128), M = 1 / 4 / 16 (decode
               instance) and 32 / 256 (tiled), each within one f16 ulp of
               its plain version, and kernel 2 at the same groups and
               rescale, bit for bit.
               Then the route table: the fused kernel against the
               materialize plan (decode kernel + library product) at M =
               256 / 512 / 2048, uint4 x f16 and int2 x int8. Then kernel
               9 (dense_matmul, the tiled dense GEMM that no part of the
               program calls; wgmma + TMA but for float32) at M = 16 /
               256 / 4096, N = K = 4096, every operand type. Every time
               is bitblas_tpu_torch.utils.timing.measure_kernel's: the
               median of CUDA events, L2
               flushed by a read before each launch; a one-element fill
               timed the same way gives the floor of a timed launch
               (timer_floor).
               Kernels 4-8 on bfloat16 queries and with Mistral-7B-v0.1's
               window (4096): kernel 4 at bf16, B = 1, H = 32, Hkv = 8,
               S = 512, and at S = 8192 with the window, bf16 and f16;
               kernels 5 / 6 at B = 4, H = 32, Hkv = 8, bf16 queries, the
               window, lengths 1 / 37 / 4097 / 8000 over Smax = 8192;
               kernels 7 / 8 on bf16 queries. These bounds count the
               band: 4 H D sum_i min(i + 1, window) products for prefill,
               min(len, window) keys a sequence for decode; the library
               call is SDPA with the band as a boolean mask.
               Kernel 1 uint4 x f16 g128 at Mixtral-8x7B's expert shapes
               (N x K = 14336 x 4096 and 4096 x 14336): M = 8 (the decode
               capacity, split-K decode instance) and 256 (tiled), as
               above; the materialize plan at M = 2048 (kernel 2 bit-equal
               to its plain decode, timed on its own; the product
               bit-equal to cuBLAS's on that weight, within one ulp or
               4e-3 of the largest output of the plain version).
3b. edges   -- untimed: kernel 9 at every tile, type and M tail; kernel
               1's decode instances at M = 1 / 3 / 8 / 16 over a ragged N
               (int2 also over a K tail of 64);
               kernel 1's tiled instances, both formats, at M tails over a
               ragged N and K tails;
               the decode kernels at head dim 256, GQA groups 16 and 12
               and on float16 caches; each against its plain version, two
               calls bit-equal.
3b. window_edges -- untimed: kernel 4 at S = 64 / 128 / 8192, f16 and
               bf16, windows 1, 63, 64, 65 and >= S (a window >= S
               bit-equal to none); kernels 5 / 6 with f16 and bf16
               queries, windows 1, 63, 64, 65 and >= Smax, lengths window
               - 1, window and window + 1 over Smax = 8192, splits that
               hold no live key; each against its plain version (and the
               split one), two calls bit-equal.
3b. flashatten -- kernel 4 through ops/flashatten.FlashAtten, a grid of
               the configurations JAX's flash kernel takes: head dims 64 /
               80 / 96 / 100 / 128 / 256 (wgmma) and 160 (general), causal
               and dense, nnn and ntn (K^T), S = 2048 (D = 128: the kernels
               line's four) and 160 (ragged, D = 80 / 160), float16,
               bfloat16, float32 and
               float16 with a float32 Out_dtype, B = 1, H = Hkv = 32; each
               against its plain version element by element (one ulp of
               the coarser of operand and output type of |ref| plus four
               of the row's rms), kernel_ms at the default tile, each
               tile's ms, plain_ms, SDPA's ms on the same operands (the
               library yardstick), stream_ms and the bound; the launches
               counted per variant (flashatten_launches in the kernels
               line, apart from the serve phases' launches);
               hardware_aware_finetune's winner against the default on
               three configurations at head dim 64 (the one that builds
               both tiles); a tuned operator through the hint database.
3b'. formats -- kernels 1 and 2 for the 21 other (A, W) pairs with
               float16 / bfloat16 activations (uint1/2/4, int1/2/4/8, nf4,
               fp4_e2m1, e4m3, e5m2; ops/matmul_config.FLOAT_PAIRS): a
               module.Linear for each pair at Llama-2-7B's MLP shapes
               (11008 x 4096 and 4096 x 11008; scales in groups of 128,
               uint with zeros) built on the card from reference-layout
               operands drawn from a seed, and QuantLinear(bits=1 / 2) at
               4096 -> 11008 from pack(); the main path (each Linear at M =
               4 / 256 / 2048: the decode instance, the tiled instance and
               the materialize plan, each QuantLinear at 4 / 256) run with
               the launch counters set to 0 and read after (every format's
               decode instance, tiled instance and kernel 2 must launch);
               then each fused output within one ulp of the output type of
               its plain version (out_ulps; the materialize plan's output
               bit-equal to cuBLAS's product of the plain decoded weight
               and within one ulp or 4e-3 of the largest output of the
               float32 plain version; the route table's two routes the
               same), two calls bit-equal, kernel 2's
               weight and kernel 1's (one-hot activations) bit-equal to
               the plain one, kernel 2 on every code of each format, the
               timed rows (M = 4, M = 256, kernel 2) beside bound, stream,
               plain, library (torch.matmul on the decoded weight) and the
               timer floor, and each format's route table (M = 256 / 512 /
               2048). `--formats` runs this phase alone.
3b''. int_formats -- kernel 1's integer column (int8 activations with
               uint1/2/4 at Llama-2-7B's MLP, N = 11008, and int1/2/4 at
               W2A8's N = 14336, K = 4096; ops/matmul_config.INT_PAIRS):
               per format a module.Linear unscaled (int32 out), per
               channel (float16 / float32 out) and at g = 128 with a bias
               (uint also zeros; saturating int8 out), QuantLinear(bits =
               1 / 2 / 4, A_dtype="int8"), and uint4 x float16's
               other layers (unscaled, scales without zeros, float32
               out); the
               main path (each Linear at M = 4 / 256 / 2048, the last on
               materialize where allowed) counted as in the formats
               phase (every format's decode and tiled instances, kernel
               3 at 1 bit, uint4 x float16's instances and kernel 2 must
               launch); then the decode instance bit-equal to its split
               plain version, unscaled (int32) outputs bit-equal on every
               route, scaled ones within one ulp of the float32 plain
               version or nearer a float64 truth, int8 within 1 after
               saturation, two calls bit-equal; kernel 3 on every code of
               the six formats bit-equal; timed rows (decode M = 4, tiled
               M = 256 on the g = 128 layers, kernel 3 at 1 bit, uint4 x
               float16's instances and kernel 2) beside bound, stream,
               plain and library (torch._int_mm on pre-decoded codes);
               the route table of each per-channel layer. `--int-formats`
               runs this phase alone.
3b'''. ops -- the operator surface at full width (check_ops): at
               ResNet-50's residual-stage convolutions (CONV_SHAPES,
               batch 32) a dense Conv2D (cuDNN), QuantConv2D uint4 g128
               with a bias on the materialize route (kernel 2) and the
               fused one (im2col patches into kernel 1's tiled
               instance), and with int8 activations, uint4 per channel,
               on both (kernel 3 and the exact int32 convolution; kernel
               1's integer instance); MatmulWithSplitK at Llama-2-7B's
               projections (M = 1 / 4 / 16, k_split 2 and 4; kernel 1's
               decode instance a shard) beside Matmul; BatchMatmul f16 and
               int8 at the attention product (32 heads, M = N = 512, K =
               128); QuantCompress, LOP3Permutate and LadderPermutate at
               11008 x 4096. The main path counted (kernels 1-3 must
               launch), each op against its plain version on the card
               (the limits OPS_*), timed rows with bounds, kernel 2's
               share of the materialize route, and measure_chained
               beside measure_kernel(flush=False) on kernel 1's decode
               instance. `--ops` runs this phase alone.
3c. gptq_golden -- the committed AutoGPTQ golden (g = 64) repacked, v1
               and v2, into module.Linear (zeros mode quantized) and
               QuantLinear on the card: dequantized weights bit-equal, the
               2-layer logits within tests/test_gptq_golden.py's
               tolerance.
3d. linear  -- an AutoGPTQ bundle at 4096 -> 11008, g = 128 and 64, drawn
               on the card, through Linear.repack_from_gptq and
               QuantLinear.repack_from_gptq_v2; forwards at M = 1 / 16 /
               256 / 1024 against the plain version; a checkpoint round
               trip bit for bit and a JAX-stamped checkpoint refused.
4. reference -- a 1-layer model at Llama-2-7B widths: prefill (flash) and
               teacher-forced decode steps on the card against the same
               weights on the CPU plain path; then TokenContinuousBatching-
               Engine(num_slots=4) on both, bf16 and int8 KV, four greedy
               requests in buckets 256/512 (per-step logits, tokens, final
               hidden states); then PagedContinuousBatchingEngine, bf16 and
               int8, four requests of which two share a 256-token prefix
               (per-step block tables, prefix hits, logits of the hidden
               states and their greedy tokens). The same for 2 BitNet
               layers at Llama-3-8B widths: prefill in bucket 512, decode
               steps, the token engine; each BitLinear of a layer equal
               bit for bit at M = 4 and 512, logits within fixed limits
               (BITNET_LOGIT_*, set from readings over seeds and below
               the readings of a glue fault), greedy tokens equal wherever
               the CPU's top-2 margin exceeds the limit, of which there
               must be a minimum number, and elsewhere the card's pick
               within the limit of the CPU's best. reference_gptq: 2
               layers imported from an AutoGPTQ state dict (g = 64) on the
               card and on the CPU, prefill and decode steps as above.
4b. reference_mistral -- 1 layer (2 until PR 14, cut for the run's
               time) at Mistral-7B-v0.1's widths, bf16,
               the window reduced to 256 (a CPU plain reference over
               prompts past 4096 keys costs too much), card against the
               CPU: prefill in bucket 512 and teacher-forced decode steps,
               the token engine on bf16 and int8 KV, with prefill_chunk =
               64, with kv_ring on bf16 and int8, the paged engine on bf16
               and int8 (the window through the masked gather), and a
               windowless bf16 model on the paged engine (kernels 7 / 8 on
               bf16 queries); logits within MISTRAL_REF_TOL of the
               largest.
4c. reference_bitnet_3b -- 2 BitNet layers at b1.58-3B's widths (head
               dim 100), card against CPU: each BitLinear bit for bit at
               M = 4 and 512, prefill in buckets 256 and 512 (kernel 4 at
               D = 100 on the card) and teacher-forced decode steps (the
               plain D = 100 decode attention on both, as in JAX), hidden
               states within BITNET_3B_HIDDEN of the largest, the
               prefill's after the first layer within
               BITNET_3B_LAYER1_RMS (rms), logits within the BitNet
               limits, tokens equal wherever the CPU's top-2 margin
               exceeds the limit; then the token engine.
4d. reference_mixtral -- 1 layer at Mixtral-8x7B's widths (8 experts
               top-2), imported from a synthetic AutoGPTQ v1 state dict on
               the card and on the CPU at capacity factor 4 (no drops):
               prefill in bucket 512 and teacher-forced decode steps, then
               the token engine (buckets 256 / 512), card against CPU at
               the f16 tolerances, the CPU replaying the card's expert
               choices (RouteReplay); route flips counted, each one's CPU
               top-k margin under MIXTRAL_FLIP_MARGIN.
5. serve    -- 32-layer W4A16 Llama-2-7B widths (random weights from a
               seeded generator on the card) behind an LMHead (vocab 32000),
               four greedy requests (prompts 200/300/450/500, 32 new tokens)
               on four slots, through
               serve            TokenContinuousBatchingEngine, bf16 KV;
               serve_kv_quant   the same with int8 KV;
               serve_paged      PagedContinuousBatchingEngine (block size
                                16, 64 blocks per slot), bf16, the prompts
                                embedded, plus two requests sharing a
                                256-token prefix;
               serve_paged_quant  the same over the int8 pool;
               serve_gptq       an AutoGPTQ v1 state dict at Llama-2-7B
                                widths, g = 64, drawn on the card,
                                imported (load_quant_llama_from_hf_gptq,
                                timed) and served as `serve` (token
                                engine, bf16 KV);
               serve_mistral    32 Mistral-7B-v0.1 layers (W4 g128, bf16,
                                window 4096; four prompts of 1000 / 3000 /
                                4500 / 6000 tokens, max_seq_len 8192),
                                token engine, bf16 KV: the windowed
                                kernels 4 and 5 must launch;
               serve_mistral_kv_quant  the same on int8 KV (windowed
                                kernel 6);
               serve_mistral_ring  prefill_chunk = 256, kv_ring (4352
                                ring rows a slot); the attends are torch
                                ops, counted (ring_attends);
               serve_bitnet_3b  all 26 BitNet b1.58-3B layers (hidden
                                3200, intermediate 8640, head dim 100,
                                vocab 32002), prompts of 200 / 450 / 1000
                                / 1900 tokens (buckets 256 ... 2048, every
                                one through kernel 4 at D = 100), bf16
                                slot cache of 4 x 2048 rows;
               serve_mixtral    32 Mixtral-8x7B-v0.1 layers (W4 g128,
                                f16, 8 experts top-2, capacity factor 2;
                                24,670,896,128 packed bytes), Mistral's
                                four prompts, max_seq_len 8192, token
                                engine, bf16 KV: every expert at M = 8 on
                                the decode instance, prefill capacities
                                512-4096 on the materialize plan;
               serve_bitnet     32 BitNet b1.58 W2A8 layers at Llama-3-8B
                                widths behind an LMHead of vocab 128256,
                                TokenContinuousBatchingEngine, bf16 KV, on
                                untuned operators (buckets 1 ... 256).
               Prompts of 300-500 tokens prefill in bucket 512, the
               materialize route. Every request finishes, hiddens and
               logits are finite, and every kernel of the phase's path has
               a launch counter (all reset to 0 just before the phase) > 0.
               The GEMM launches equal the routes of the Matmul calls
               (recorded by weight format): one fused launch a "fused"
               call, one weight decode a "materialize" call, and as many
               launches of kernel 1's split-K decode instances
               (dequant_matmul_{u4,i2}.decode_launches) and of its wgmma +
               TMA tiled instances (.tiled_launches) as fused calls whose
               hint names one: on untuned operators, the fused calls with
               M <= 16 and M > 16. A profile of 5 decode steps follows
               each token-engine phase.
6. tune     -- the distinct Matmul configurations of both serving models
               at full width (W4A16: 3 shapes, buckets 1/16/256; W2A8: 4
               shapes, buckets 1/16/32/64/128/256) tuned through the global
               operator cache on the card: each bucket's winner, its time
               and spread, the default's time and the roofline; the hints
               saved into a database in a temporary directory, the cache
               cleared and loaded back (hints equal), and each reloaded
               operator's forward equal to the tuned operator's bit for
               bit at M = 4 and 256 (and to the default route's: int2 bit
               for bit, uint4 within one f16 rounding).
7. serve_bitnet_tuned -- serve_bitnet again, on a model whose layers take
               the operators loaded from that database; the GEMM kernels'
               launches must equal the routes its Matmul calls took (as in
               every serve phase), beside serve_bitnet's metrics.

8. the model tools (after the kernels phase; `--quantize` runs them
   alone, after the kernels phase's rows of kernels 1, 2, 4 and 5):
   quantize_llama    float16 weights at Llama-2-7B's widths, 32 layers,
                     drawn on the card (N(0, 0.02), embedding and lm_head
                     N(0, 0.05), norms 1), quantized by GPTQ (uint4 g128,
                     2 x 512 calibration tokens, sequential, q / k / v and
                     gate / up swept as stacked rows) through
                     models/quantize_hf on the card: seconds a layer and
                     in all, the packed bytes (serve's 3,440,377,856),
                     GPTQ's objective against RTN's for every projection
                     of layers 0 and 31 (not worse), layer 0's q through
                     kernel 2 and kernel 1 on one-hot rows bit-equal to
                     the QuantizedWeight with float16 scales; then RTN of
                     the same weights;
   serve_quantized   the GPTQ model served as `serve`;
   speculative       the GPTQ model as target, drafts (a) itself and (b)
                     the RTN model: `generate` (timed) on a 256-token
                     prompt, 64 new tokens; cached speculation at gamma 4
                     (timed) and uncached (16 tokens), tokens equal to
                     generate's up to the first position whose
                     teacher-forced top-2 margin is under SPEC_FLIP_MARGIN
                     (at least SPEC_MIN_DECIDED; the card's change of
                     that top-2 gap between generate's decode_step path
                     and decode_chunk's, the verify's, under the limit),
                     draft (a) accepting every proposal there; a seeded
                     sampled run repeated; kernels 1, 4 and 5 must
                     launch;
   quantize_mixtral  one layer at Mixtral-8x7B's widths, GPTQ with
                     routed calibration; one expert kept from every
                     top-2 (a -10 router weight on a channel every
                     embedding holds at ZERO_CHANNEL_VALUE, 2.0) must be
                     RTN's bit for bit,
                     every expert with traffic not worse than RTN;
   reference_quantize  one Llama-2-7B-width layer quantized on the card
                     and on the CPU: RTN bit-equal, the graphed sweep
                     bit-equal to the eager one, the card's sweep on the
                     CPU's weights and Hessians bit-equal to the CPU's
                     codes, scales and zeros, the layer objective within
                     QUANT_REF_OBJECTIVE of the CPU's; reported: the share
                     of equal codes by projection, the Hessians' gap, and
                     the sweep on float32-rounded H and on a float32 U;
   bitnet_train      bitlinear_train_forward at 14336 x 4096, 256 rows,
                     forward and backward against the CPU's float64
                     truth.

9. slice 19 (`--danube` runs them alone):
   slice19_prefill  kernel 4's d80 instance at H2O-Danube-1.8B's longest
                    bucket (B = 1, H = 32, Hkv = 8, bf16, window 4096, S =
                    8192), its general instance at what only it takes: f16
                    causal D = 512 (H = 8), bf16 D = 160, D = 100 over 25
                    heads, K^T at S = 2047, and the float32 kernel (3xTF32)
                    at D = 6, 288 and 768 (H = 8; S = 2048; D = 128 at H
                    = 32 is flashatten's row), its bound at float32-
                    accurate TF32 products; each against its plain version
                    (K amplified 3x, one ulp of |ref| plus 4 of the row's
                    rms; the float32 rows also against a float64 truth,
                    `f32_held`), the row's
                    launch counted, timed beside SDPA;
   slice19_decode   kernels 5-8 at D = 512 (the wide instances: a cluster
                    of 4 column slices; B = 4, H = 16, Hkv = 4, Smax
                    4096, lengths 1 / 37 / 2049 / 4096, K amplified 20x),
                    the slot kernels also with a window of 1024, kernels
                    5-6's partial_stats outputs;
   reference_danube one Danube layer (window 256) card against the CPU's
                    plain route, prefill (the d80 kernel) and 4 decode
                    steps, held at the first layer's DANUBE_LAYER1_TOL;
   engine_d512      a 2-layer model at head dim 512 on the token and paged
                    engines, bf16 and int8 caches, card against CPU (logits
                    within 2e-2); kernel 4's general d512 and kernels 5-8
                    at d512 must launch;
   serve_danube     24 layers at H2O-Danube-1.8B's widths (W4 g128 under
                    bf16, window 4096), Mistral's prompts, the token engine
                    with a bf16 cache of 4 x 8192 rows; kernel 4's d80
                    instance (windowed and not), kernel 1's uint4 x bf16
                    instances and kernel 2 must launch, no prefill may take
                    the plain softmax; the plain D = 80 decode attention's
                    calls (JAX's XLA route) are counted.

Then the kernel summary line, the nvidia-smi line, and the last line
{"ok": true, "device": {...}}.
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

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F16_FLOPS_PER_S = 989e12       # dense f16/bf16 tensor core, data sheet
INT8_OPS_PER_S = 1979e12       # dense int8 tensor core, data sheet
F32_FLOPS_PER_S = 67e12        # float32 FFMA (no tensor core), data sheet
TF32_FLOPS_PER_S = 495e12      # dense TF32 tensor core, data sheet
# float32-accurate products on the TF32 tensor cores: three TF32 products
# a float32 one (the 3xTF32 split of kernel 4's float32 kernel)
F32X3_FLOPS_PER_S = TF32_FLOPS_PER_S / 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float, peak: float = F16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters: int, flush=True) -> float:
    """Median per-launch device time in ms: bitblas_tpu_torch.utils.timing
    .measure_kernel (CUDA events, L2 flushed before each launch when
    `flush`, a device sleep queued first so no launch waits on the
    host)."""
    from bitblas_tpu_torch.utils.timing import measure_kernel
    return measure_kernel(fn, (), iters=iters, flush=bool(flush)) * 1e3


# Kernel 1's split-K decode instance against its split plain version: the
# same f32 partials in the same split order, but each group's sums in the
# mma's own order, so at most one f16 ulp of each output apart, plus the
# f32 rounding of the sums, which near a zero output exceeds that output's
# ulp: SPLIT_ULP_FLOOR of the largest output (2^-24 of it measured between
# the plain version and exact sums, N x K = 11008 x 4096 and 4096 x 11008).
SPLIT_ULP_FLOOR = 2.0 ** -18


def f16_ulps(torch, got, want) -> float:
    """The largest |got - want| in units of (want's float16 ulp +
    SPLIT_ULP_FLOOR of the largest |want|): at most 1 when got is within
    one f16 ulp of each output."""
    w = want.double()
    # floor(log2 |w|) exactly (log2 of a power of two can fall a hair
    # short, halving that output's unit), at least float16's -14
    e = (torch.frexp(w.abs().clamp_min(2.0 ** -14))[1] - 1).double()
    unit = torch.exp2(e - 10) + SPLIT_ULP_FLOOR * w.abs().max()
    return ((got.double() - w).abs() / unit).max().item()


def check_dequant(torch, flush, shapes=((4096, 4096), (11008, 4096),
                                        (4096, 11008)),
                  ms=(1, 4, 16, 32, 64, 128, 256, 512), seed=1, extra=None):
    """Kernel 1 uint4 x f16 at Llama-2-7B's W4A16 shapes (or `shapes`), M
    = 1 / 4 / 16 (the split-K decode instance: within one f16 ulp of each
    output of the split-then-merge plain version, `f16_ulps`) and 32 / 64
    / 128 / 256 / 512 (the default wgmma + TMA tile, 64 tokens x 128
    weight rows: it decodes the plain version's f16 weights bit for bit,
    so within one f16 ulp of each output of the single-pass plain
    version), on the default tile of each M; every row two calls
    bit-equal and within 4e-3 of the largest output of the single-pass
    plain version. `extra` joins each row."""
    from bitblas_tpu_torch.kernels.dequant_matmul import (
        default_tile, dequant_matmul_u4, dequant_matmul_u4_plain,
        dequant_matmul_u4_split_plain, dequantize_hopper, plan_splits_k)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for (N, K) in shapes:
        G = K // 128
        qw = torch.randint(-2 ** 31, 2 ** 31, (N, K // 8), generator=gen,
                           device="cuda", dtype=torch.int64).to(torch.int32)
        sc = (torch.rand((G, N), generator=gen, device="cuda") * 0.01
              + 0.005).half()
        zr = torch.randint(0, 16, (G, N), generator=gen,
                           device="cuda").half()
        Wd = dequantize_hopper(qw, sc, zr)
        for M in ms:
            A = torch.randn((M, K), generator=gen, device="cuda").half()
            out = dequant_matmul_u4(A, qw, sc, zr)
            ref = dequant_matmul_u4_plain(A, qw, sc, zr)
            if not torch.equal(out, dequant_matmul_u4(A, qw, sc, zr)):
                raise AssertionError(f"dequant M={M} N={N} K={K}: two "
                                     f"calls differ")
            split_ulps = tiled_ulps = None
            if M <= 16:
                split = dequant_matmul_u4_split_plain(A, qw, sc, zr, sms=sms)
                split_ulps = f16_ulps(torch, out, split)
                if not split_ulps <= 1:
                    raise AssertionError(
                        f"dequant M={M} N={N} K={K}: {split_ulps} f16 ulps "
                        f"from the split plain version")
            else:
                tiled_ulps = f16_ulps(torch, out, ref)
                if not tiled_ulps <= 1:
                    raise AssertionError(
                        f"dequant M={M} N={N} K={K}: {tiled_ulps} f16 ulps "
                        f"from the plain version")
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            # against the single-pass plain version (weights decoded to
            # f16): the order of the f32 sums and the f16 rounding of each
            # weight differ, then one f16 rounding (2^-11 relative)
            tol = 4e-3 * scale
            if not (err <= tol and torch.isfinite(out).all().item()):
                raise AssertionError(f"dequant M={M} N={N} K={K}: max abs "
                                     f"err {err} > {tol}")
            wbytes = N * K / 2 + 2 * G * N * 2
            nbytes = M * K * 2 + wbytes + M * N * 2
            b_ms, b_by = bound(nbytes, 2.0 * M * N * K)
            row = {
                "phase": "kernels", "kernel": "dequant_matmul_u4",
                "M": M, "N": N, "K": K, **(extra or {}),
                "tile": list(default_tile("uint4", M)),
                "splits": plan_splits_k(M, N, K, sms) if M <= 16 else None,
                "max_abs_err": err,
                "max_rel_err": err / max(scale, 1e-30), "tol": tol,
                "split_ulps": split_ulps, "tiled_ulps": tiled_ulps,
                "kernel_ms": time_ms(torch, lambda: dequant_matmul_u4(
                    A, qw, sc, zr), 20, flush),
                "plain_ms": time_ms(torch, lambda: dequant_matmul_u4_plain(
                    A, qw, sc, zr), 3, flush),
                "library_ms": time_ms(torch, lambda: torch.matmul(A, Wd.T),
                                      20, flush),
                "stream_ms": time_ms(torch, _stream(torch, nbytes), 20,
                                     flush),
                "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            rows.append(row)
    return rows


def _int8(torch, gen, shape):
    return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                         dtype=torch.int64).to(torch.int8)


def _words(torch, gen, shape):
    """Random int32 words: every 2- and 4-bit code occurs."""
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         device="cuda", dtype=torch.int64).to(torch.int32)


def _exact_row(torch, kernel, out, ref, extra, timed, flush):
    """A kernel row whose result must equal its plain version bit for bit
    (integer sums, or the same decode formula): tolerance 0."""
    torch.cuda.synchronize()
    if out.dtype != ref.dtype or out.shape != ref.shape:
        raise AssertionError(f"{kernel}: {out.dtype} {tuple(out.shape)} vs "
                             f"{ref.dtype} {tuple(ref.shape)}")
    err = (out.float() - ref.float()).abs().max().item()
    if not (err == 0.0 and torch.isfinite(out.float()).all().item()):
        raise AssertionError(f"{kernel} {extra}: max abs err {err} > 0")
    row = {"phase": "kernels", "kernel": kernel, **extra,
           "max_abs_err": err, "max_rel_err": 0.0, "tol": 0.0}
    for col, (fn, iters) in timed.items():
        row[col] = time_ms(torch, fn, iters, flush) if fn else None
    emit(row)
    return row


BITNET_SHAPES = ((14336, 4096), (4096, 14336))   # gate/up, down
# and q / o, k / v: the decode instance's rows run all four
BITNET_DECODE_SHAPES = BITNET_SHAPES + ((4096, 4096), (1024, 4096))


def check_dequant_i2(torch, flush):
    """The W2A8 kernel on the default tile of each M: M = 1 / 4 / 16 (the
    split-K decode instance) on BitNet's four projection shapes, and 32 /
    64 / 128 / 256 / 512 (the default wgmma + TMA tile) on its MLP shapes;
    bit-equal to the plain version (and, at M <= 16, to the split-then-
    merge plain version), two calls bit-equal. The decode rows also time
    the 32 x 64 wgmma tile on the same operands (`tile_32x64_ms`). The
    yardstick is one library product on the pre-decoded weight:
    torch._int_mm on int8 where it takes the shape (M > 16), else
    torch.matmul on float32 copies (exact: |sum| <= K * 256 < 2^24, and
    TF32 is off by default); it must equal the plain version too."""
    from bitblas_tpu_torch.kernels.dequant_matmul import (
        FUSED_TILES, decode_i2_hopper, default_tile, dequant_matmul_i2,
        dequant_matmul_i2_plain, dequant_matmul_i2_split_plain,
        plan_splits_k_i2)
    tile_32x64 = FUSED_TILES["int2"][1]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for (N, K) in BITNET_DECODE_SHAPES:
        qw = _words(torch, gen, (N, K // 16))
        Wi = decode_i2_hopper(qw)
        Wf = Wi.float()
        ms = (1, 4, 16) + ((32, 64, 128, 256, 512) if (N, K) in
                           BITNET_SHAPES else ())
        for M in ms:
            A = _int8(torch, gen, (M, K))
            ref = dequant_matmul_i2_plain(A, qw)
            out = dequant_matmul_i2(A, qw)
            if not torch.equal(out, dequant_matmul_i2(A, qw)):
                raise AssertionError(f"dequant_i2 M={M} N={N} K={K}: two "
                                     f"calls differ")
            extra, timed = {}, {}
            if M <= 16:
                if not torch.equal(out, dequant_matmul_i2_split_plain(
                        A, qw, sms=sms)):
                    raise AssertionError(f"dequant_i2 M={M} N={N} K={K}: "
                                         f"differs from the split plain "
                                         f"version")
                extra["splits"] = plan_splits_k_i2(M, N, K, sms)
                timed["tile_32x64_ms"] = (lambda: dequant_matmul_i2(
                    A, qw, tile=tile_32x64), 20)
            if M > 16:
                lib_name, lib = "torch._int_mm", lambda: torch._int_mm(
                    A, Wi.T)
            else:
                Af = A.float()
                lib_name, lib = "torch.matmul f32", lambda: torch.matmul(
                    Af, Wf.T)
            if not torch.equal(lib().float(), ref):
                raise AssertionError(f"{lib_name} M={M} N={N} K={K} differs "
                                     f"from the int32 sums")
            nbytes = M * K + N * K / 4 + M * N * 4
            b_ms, b_by = bound(nbytes, 2.0 * M * N * K, INT8_OPS_PER_S)
            rows.append(_exact_row(
                torch, "dequant_matmul_i2", out, ref,
                {"M": M, "N": N, "K": K,
                 "tile": list(default_tile("int2", M)), **extra,
                 "bound_ms": b_ms, "bound_by": b_by, "library": lib_name},
                {"kernel_ms": (lambda: dequant_matmul_i2(A, qw), 20),
                 "plain_ms": (lambda: dequant_matmul_i2_plain(A, qw), 3),
                 "library_ms": (lib, 20),
                 "stream_ms": (_stream(torch, nbytes), 20), **timed},
                flush))
        del Wi, Wf
    return rows


def check_weight_decode(torch, flush):
    """Kernel 2 (uint4 -> f16) at Llama-2-7B's MLP shapes and kernel 3
    (int2 -> int8) at BitNet's. No single PyTorch call computes either
    decode: library_ms is null."""
    from bitblas_tpu_torch.kernels.materialize import (
        weight_decode_int8, weight_decode_int8_plain, weight_decode_u4,
        weight_decode_u4_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    u4, i8 = [], []
    for (N, K) in ((11008, 4096), (4096, 11008)):
        G = K // 128
        qw = _words(torch, gen, (N, K // 8))
        sc = (torch.rand((G, N), generator=gen, device="cuda") * 0.01
              + 0.005).half()
        zr = torch.randint(0, 16, (G, N), generator=gen, device="cuda").half()
        nbytes = N * K / 2 + 2 * G * N * 2 + N * K * 2
        b_ms, b_by = bound(nbytes, 0.0)
        u4.append(_exact_row(
            torch, "weight_decode_u4", weight_decode_u4(qw, sc, zr),
            weight_decode_u4_plain(qw, sc, zr),
            {"N": N, "K": K, "out": "float16", "bound_ms": b_ms,
             "bound_by": b_by},
            {"kernel_ms": (lambda: weight_decode_u4(qw, sc, zr), 20),
             "plain_ms": (lambda: weight_decode_u4_plain(qw, sc, zr), 3),
             "library_ms": (None, 0),
             "stream_ms": (_stream(torch, nbytes), 20)}, flush))
    for (N, K) in BITNET_SHAPES:
        qw = _words(torch, gen, (N, K // 16))
        nbytes = N * K / 4 + N * K
        b_ms, b_by = bound(nbytes, 0.0)
        i8.append(_exact_row(
            torch, "weight_decode_int8", weight_decode_int8(qw),
            weight_decode_int8_plain(qw),
            {"N": N, "K": K, "bits": 2, "family": "int", "bound_ms": b_ms,
             "bound_by": b_by},
            {"kernel_ms": (lambda: weight_decode_int8(qw), 20),
             "plain_ms": (lambda: weight_decode_int8_plain(qw), 3),
             "library_ms": (None, 0),
             "stream_ms": (_stream(torch, nbytes), 20)}, flush))
    return u4, i8


# GPTQ's options on kernel 1 and kernel 2 at Llama-2-7B's MLP shapes:
# (group: -1 per channel; zeros mode; bias; (N, K) shapes)
GPTQ_VARIANTS = (
    (32, "original", False, ((11008, 4096), (4096, 11008))),
    (64, "original", False, ((11008, 4096), (4096, 11008))),
    (-1, "original", False, ((11008, 4096), (4096, 11008))),
    (128, "rescale", False, ((11008, 4096),)),
    (128, "original", True, ((11008, 4096),)),
)
GPTQ_MS = (1, 4, 16, 32, 256)   # the decode instance, then the tiled one


def _gptq_operands(torch, gen, N, K, group, mode):
    """Random codes, [K/g, N] scales and zeros of a group size and zeros
    mode (rescale: z * s, as the import makes them)."""
    G = K // group
    qw = _words(torch, gen, (N, K // 8))
    sc = (torch.rand((G, N), generator=gen, device="cuda") * 0.01
          + 0.005).half()
    zr = torch.randint(0, 16, (G, N), generator=gen, device="cuda").half()
    if mode == "rescale":
        zr = (zr * sc).half()
    return qw, sc, zr


def check_gptq_kernels(torch, flush):
    """Kernel 1 at GPTQ's group sizes 32, 64 and per channel (both MLP
    shapes), zeros mode rescale and a bias (g = 128), M = 1 / 4 / 16 on
    the split-K decode instance (within one f16 ulp of each output of the
    split plain version) and M = 32 / 256 on the default tiled instance
    (within one f16 ulp of the plain version); every row within 4e-3 of
    the plain version's largest output, two calls bit-equal, each launch
    counted (decode_launches / tiled_launches and the variant's own
    count). Kernel 2 at each group and rescale, bit for bit its plain
    version. Bound: the bytes N K / 2 + 4 N K / g (+ 4 N of bias) +
    activations + outputs over 3.35 TB/s, or the f16 tensor-core peak;
    library: torch.matmul on the f16 weight (kernel 2: none)."""
    from bitblas_tpu_torch.kernels.dequant_matmul import (
        default_tile, dequant_matmul_u4, dequant_matmul_u4_plain,
        dequant_matmul_u4_split_plain, dequantize_hopper, plan_splits_k,
        u4_variant)
    from bitblas_tpu_torch.kernels.materialize import (
        weight_decode_u4, weight_decode_u4_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    u4 = dequant_matmul_u4
    rows, wd = [], []
    for group, mode, with_bias, shapes in GPTQ_VARIANTS:
        for (N, K) in shapes:
            grp = K if group == -1 else group
            qw, sc, zr = _gptq_operands(torch, gen, N, K, grp, mode)
            bias = (torch.randn(N, generator=gen, device="cuda")
                    if with_bias else None)
            Wd = dequantize_hopper(qw, sc, zr, grp, mode)
            kw = dict(bias=bias, zeros_mode=mode)
            for M in GPTQ_MS:
                A = torch.randn((M, K), generator=gen, device="cuda").half()
                kind = "decode" if M <= 16 else "tiled"
                key = u4_variant(kind, grp, K, mode, with_bias)
                before = (u4.variant_launches.get(key, 0),
                          u4.decode_launches, u4.tiled_launches)
                out = u4(A, qw, sc, zr, grp, **kw)
                if not torch.equal(out, u4(A, qw, sc, zr, grp, **kw)):
                    raise AssertionError(f"{key} M={M} N={N} K={K}: two "
                                         f"calls differ")
                after = (u4.variant_launches.get(key, 0),
                         u4.decode_launches, u4.tiled_launches)
                want = (before[0] + 2, before[1] + 2 * (kind == "decode"),
                        before[2] + 2 * (kind == "tiled"))
                if after != want:
                    raise AssertionError(f"{key}: launches {after} != {want}")
                ref = dequant_matmul_u4_plain(A, qw, sc, zr, grp, **kw)
                held = ref if kind == "tiled" else \
                    dequant_matmul_u4_split_plain(A, qw, sc, zr, sms=sms,
                                                  group=grp, **kw)
                ulps = f16_ulps(torch, out, held)
                err = (out.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                tol = 4e-3 * scale
                if not (ulps <= 1 and err <= tol
                        and torch.isfinite(out).all().item()):
                    raise AssertionError(
                        f"{key} M={M} N={N} K={K}: {ulps} f16 ulps from "
                        f"the {'split ' if kind == 'decode' else ''}plain "
                        f"version, max abs err {err} (tol {tol})")
                nbytes = (M * K * 2 + N * K / 2 + 4 * N * K / grp
                          + M * N * 2 + (4 * N if with_bias else 0))
                b_ms, b_by = bound(nbytes, 2.0 * M * N * K)
                row = {
                    "phase": "kernels", "kernel": "dequant_matmul_u4",
                    "variant": key, "group": grp, "zeros_mode": mode,
                    "bias": with_bias, "M": M, "N": N, "K": K,
                    "tile": list(default_tile("uint4", M)),
                    "splits": (plan_splits_k(M, N, K, sms)
                               if kind == "decode" else None),
                    "max_abs_err": err,
                    "max_rel_err": err / max(scale, 1e-30), "tol": tol,
                    "f16_ulps": ulps,
                    "kernel_ms": time_ms(torch, lambda: u4(
                        A, qw, sc, zr, grp, **kw), 20, flush),
                    "plain_ms": time_ms(
                        torch, lambda: dequant_matmul_u4_plain(
                            A, qw, sc, zr, grp, **kw), 3, flush),
                    "library_ms": time_ms(
                        torch, lambda: torch.matmul(A, Wd.T), 20, flush),
                    "stream_ms": time_ms(torch, _stream(torch, nbytes), 20,
                                         flush),
                    "bound_ms": b_ms, "bound_by": b_by}
                emit(row)
                rows.append(row)
            if with_bias:
                continue   # kernel 2 has no bias: it follows the GEMM
            nbytes = N * K / 2 + 4 * N * K / grp + N * K * 2
            b_ms, b_by = bound(nbytes, 0.0)
            dec = weight_decode_u4(qw, sc, zr, group=grp, zeros_mode=mode)
            if not torch.equal(dec, weight_decode_u4(
                    qw, sc, zr, group=grp, zeros_mode=mode)):
                raise AssertionError(f"weight_decode_u4 g={grp} {mode}: two "
                                     f"calls differ")
            wd.append(_exact_row(
                torch, "weight_decode_u4", dec,
                weight_decode_u4_plain(qw, sc, zr, torch.float16, grp, mode),
                {"variant": key.split(" ", 1)[1], "group": grp,
                 "zeros_mode": mode, "N": N, "K": K, "out": "float16",
                 "bound_ms": b_ms, "bound_by": b_by},
                {"kernel_ms": (lambda: weight_decode_u4(
                    qw, sc, zr, group=grp, zeros_mode=mode), 20),
                 "plain_ms": (lambda: weight_decode_u4_plain(
                     qw, sc, zr, torch.float16, grp, mode), 3),
                 "library_ms": (None, 0),
                 "stream_ms": (_stream(torch, nbytes), 20)}, flush))
    return rows, wd


def route_table(torch, flush):
    """The fused kernel against the materialize plan (decode kernel, then
    torch.matmul / torch._int_mm) at M = 256 / 512 / 2048: the data a
    tuner needs to place the route bound (ops/matmul.MATERIALIZE_MIN_M).
    The two routes must agree: exactly for int2 x int8, within 4e-3 of
    the largest output for uint4 x f16 (same f16 weights; the sums run in
    another order, and cuBLAS may reduce split-K partials in f16)."""
    from bitblas_tpu_torch.kernels import materialize as mat
    from bitblas_tpu_torch.kernels.dequant_matmul import (dequant_matmul_i2,
                                                          dequant_matmul_u4)
    from bitblas_tpu_torch.kernels.spec import KernelSpec
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    rows = []
    for fmt, N, K in (("uint4", 11008, 4096), ("int2", 14336, 4096)):
        if fmt == "uint4":
            G = K // 128
            W = _words(torch, gen, (N, K // 8))
            sc = (torch.rand((G, N), generator=gen, device="cuda") * 0.01
                  + 0.005).half()
            zr = torch.randint(0, 16, (G, N), generator=gen,
                               device="cuda").half()
            spec = KernelSpec(m=512, n=N, k=K, a_dtype="float16",
                              out_dtype="float16", family="uint", bits=4,
                              group_size=128, with_scaling=True,
                              with_zeros=True)

            def fused(A):
                return dequant_matmul_u4(A, W, sc, zr)

            def decode():
                return mat.weight_decode_u4(W, sc, zr)

            Wd = decode()

            def dense(A):
                return torch.matmul(A, Wd.T)

            def plan(A):
                return mat.materialize_matmul(spec, A, W, sc, zr)
        else:
            W = _words(torch, gen, (N, K // 16))
            spec = KernelSpec(m=512, n=N, k=K, a_dtype="int8",
                              out_dtype="float32", family="int", bits=2)

            def fused(A):
                return dequant_matmul_i2(A, W)

            def decode():
                return mat.weight_decode_int8(W)

            Wd = decode()

            def dense(A):
                return torch._int_mm(A, Wd.T)

            def plan(A):
                return mat.materialize_matmul(spec, A, W)
        for M in (256, 512, 2048):
            A = (torch.randn((M, K), generator=gen, device="cuda").half()
                 if fmt == "uint4" else _int8(torch, gen, (M, K)))
            a, b = fused(A), plan(A)
            torch.cuda.synchronize()
            err = (a.float() - b.float()).abs().max().item()
            tol = 0.0 if fmt == "int2" else 4e-3 * a.float().abs().max().item()
            if not err <= tol:
                raise AssertionError(f"route {fmt} M={M}: {err} > {tol}")
            row = {"phase": "route", "format": fmt, "M": M, "N": N, "K": K,
                   "max_abs_err": err, "tol": tol,
                   "fused_ms": time_ms(torch, lambda: fused(A), 20, flush),
                   "materialize_ms": time_ms(torch, lambda: plan(A), 20,
                                             flush),
                   "decode_ms": time_ms(torch, decode, 20, flush),
                   "dense_ms": time_ms(torch, lambda: dense(A), 20, flush)}
            row["faster"] = ("materialize" if row["materialize_ms"]
                             < row["fused_ms"] else "fused")
            emit(row)
            rows.append(row)
        del W, Wd
    return rows


DENSE_DTYPES = ("float16", "bfloat16", "float32", "int8")


def check_dense(torch, flush):
    """Kernel 9 (dense_matmul: the tiled nt GEMM, no caller in the
    program) at M = 16 / 256 / 4096, N = K = 4096, every operand type, on
    the tile the dense hint gives that M: against its plain version
    (int8 bit for bit; floats: the same float32 sums in another order and
    one rounding, within 4e-3 / 1.6e-2 / 1e-5 of the largest output for
    float16 / bfloat16 / float32), timed beside the library product
    (torch.matmul, TF32 off; torch._int_mm for int8, which refuses M <=
    16: there torch.matmul on float64 copies, exact)."""
    from bitblas_tpu_torch.kernels.dense import (dense_matmul,
                                                 dense_matmul_plain)
    from bitblas_tpu_torch.kernels.spec import KernelSpec
    from bitblas_tpu_torch.tuner import H100_SXM, default_hint
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    N = K = 4096
    tols = {"float16": 4e-3, "bfloat16": 1.6e-2, "float32": 1e-5,
            "int8": 0.0}
    peaks = {"float16": F16_FLOPS_PER_S, "bfloat16": F16_FLOPS_PER_S,
             "float32": F32_FLOPS_PER_S, "int8": INT8_OPS_PER_S}
    rows = []
    for name in DENSE_DTYPES:
        dt = getattr(torch, name)
        out_dt = torch.int32 if name == "int8" else dt
        if name == "int8":
            W = _int8(torch, gen, (N, K))
        else:
            W = torch.randn((N, K), generator=gen, device="cuda").to(dt)
        for M in (16, 256, 4096):
            A = (_int8(torch, gen, (M, K)) if name == "int8" else
                 torch.randn((M, K), generator=gen, device="cuda").to(dt))
            spec = KernelSpec(m=M, n=N, k=K, a_dtype=name,
                              out_dtype="int32" if name == "int8" else name,
                              family="int" if name == "int8" else "fp",
                              bits=8 * W.element_size(), native=True)
            tile = default_hint(spec, H100_SXM).tile[:3]
            out = dense_matmul(A, W, out_dt, tile)
            ref = dense_matmul_plain(A, W, out_dt)
            if name == "int8" and M <= 16:
                Ad, Wd = A.double(), W.double()
                lib_name, lib = "torch.matmul f64", lambda: torch.matmul(
                    Ad, Wd.T)
            elif name == "int8":
                lib_name, lib = "torch._int_mm", lambda: torch._int_mm(
                    A, W.T)
            else:
                lib_name, lib = "torch.matmul", lambda: torch.matmul(A, W.T)
            torch.cuda.synchronize()
            err = (out.double() - ref.double()).abs().max().item()
            scale = ref.double().abs().max().item()
            tol = tols[name] * scale
            if not (err <= tol and torch.isfinite(out.float()).all().item()
                    and out.dtype == out_dt):
                raise AssertionError(f"dense_matmul {name} M={M}: max abs "
                                     f"err {err} > {tol}")
            if name == "int8" and not torch.equal(
                    lib().to(torch.float64), ref.double()):
                raise AssertionError(f"{lib_name} M={M} differs from the "
                                     f"int32 sums")
            esize = W.element_size()
            nbytes = (M + N) * K * esize + M * N * out.element_size()
            b_ms, b_by = bound(nbytes, 2.0 * M * N * K, peaks[name])
            row = {"phase": "kernels", "kernel": "dense_matmul",
                   "dtype": name, "M": M, "N": N, "K": K,
                   "tile": list(tile), "max_abs_err": err,
                   "max_rel_err": err / max(scale, 1e-30), "tol": tol,
                   "kernel_ms": time_ms(torch, lambda: dense_matmul(
                       A, W, out_dt, tile), 20, flush),
                   "plain_ms": time_ms(torch, lambda: dense_matmul_plain(
                       A, W, out_dt), 3, flush),
                   "library": lib_name,
                   "library_ms": time_ms(torch, lib, 20, flush),
                   "stream_ms": time_ms(torch, _stream(torch, nbytes), 20,
                                        flush),
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            rows.append(row)
        del W
    return rows


def check_edges(torch):
    """The card tests of this slice's kernels, in every run (untimed):
    kernel 9 at every compiled tile x f16 / bf16 / int8 x M = 1 / 65 / 130
    (N = two tiles; K = 192 on the wgmma tiles, an int8 K tail of 64,
    else 384) against its plain version, int8 bit for bit, two calls
    bit-equal; kernel 1's decode instance at M = 1 / 3 / 8 / 16, N = 136
    (a ragged tile), K = 2048 (16 splits) against both plain versions
    (the split one within one f16 ulp of each output), two calls
    bit-equal; kernel 1's wgmma + TMA tiled instances, both formats, at
    M = 1 / 33 / 100 / 130, N = 192, uint4 K = 384 and int2 K = 4160
    against the plain version (uint4 within one f16 ulp of each output,
    int2 bit for bit), two calls bit-equal; the decode kernels at head
    dim 256, GQA groups 16 and 12 and on float16 caches against their
    plain versions (K amplified 20x), two calls bit-equal."""
    from bitblas_tpu_torch.kernels import flash
    from bitblas_tpu_torch.kernels.dense import (DENSE_TILES, WGMMA_STAGES,
                                                 dense_matmul,
                                                 dense_matmul_plain)
    from bitblas_tpu_torch.kernels.dequant_matmul import (
        FUSED_TILES, dequant_matmul_i2, dequant_matmul_i2_plain,
        dequant_matmul_i2_split_plain, dequant_matmul_u4,
        dequant_matmul_u4_plain, dequant_matmul_u4_split_plain)
    from bitblas_tpu_torch.serving.kv_cache import quantize_kv
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    worst = {}

    def held(name, err, tol, *finite):
        if not (err <= tol and all(torch.isfinite(x.float()).all().item()
                                   for x in finite)):
            raise AssertionError(f"edges {name}: max abs err {err} > {tol}")
        worst[name.split(" ")[0]] = max(worst.get(name.split(" ")[0], 0.0),
                                        err / max(tol, 1e-30))

    tols = {"float16": 4e-3, "bfloat16": 1.6e-2, "int8": 0.0}
    n_dense = 0
    for tile in DENSE_TILES:
        K = 192 if tuple(tile) in WGMMA_STAGES else 384
        N = 2 * tile[1]
        for name, tol_rel in tols.items():
            dt = getattr(torch, name)
            out_dt = torch.int32 if name == "int8" else dt
            for M in (1, 65, 130):
                if name == "int8":
                    A, W = _int8(torch, gen, (M, K)), _int8(torch, gen, (N, K))
                else:
                    A, W = (torch.randn(shape, generator=gen,
                                        device="cuda").to(dt)
                            for shape in ((M, K), (N, K)))
                out = dense_matmul(A, W, out_dt, tile)
                again = dense_matmul(A, W, out_dt, tile)
                ref = dense_matmul_plain(A, W, out_dt)
                torch.cuda.synchronize()
                if not torch.equal(out, again):
                    raise AssertionError(f"edges dense {tile} {name} M={M}: "
                                         f"two calls differ")
                err = (out.double() - ref.double()).abs().max().item()
                held(f"dense_matmul {tile} {name} M={M}", err,
                     tol_rel * ref.double().abs().max().item(), out)
                n_dense += 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    N, K = 136, 2048
    qw = _words(torch, gen, (N, K // 8))
    sc = (torch.rand((K // 128, N), generator=gen, device="cuda")
          * 0.05).half()
    zr = torch.randint(0, 16, (K // 128, N), generator=gen,
                       device="cuda").half()
    for M in (1, 3, 8, 16):
        A = torch.randn((M, K), generator=gen, device="cuda").half()
        out = dequant_matmul_u4(A, qw, sc, zr)
        again = dequant_matmul_u4(A, qw, sc, zr)
        ref = dequant_matmul_u4_plain(A, qw, sc, zr)
        split = dequant_matmul_u4_split_plain(A, qw, sc, zr, sms=sms)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"edges dequant_matmul_u4 M={M}: two calls "
                                 f"differ")
        held(f"dequant_matmul_u4 M={M}",
             (out.float() - ref.float()).abs().max().item(),
             4e-3 * ref.float().abs().max().item(), out)
        held(f"dequant_matmul_u4_split M={M}", f16_ulps(torch, out, split),
             1.0)
    # the int2 split-K decode instance over a ragged N and a K tail of 64
    # (17 steps of 256, the last one step of 64): bit-equal to both plain
    # versions, two calls bit-equal
    N, K = 136, 4160
    qw = _words(torch, gen, (N, K // 16))
    for M in (1, 3, 8, 16):
        A = _int8(torch, gen, (M, K))
        out = dequant_matmul_i2(A, qw)
        again = dequant_matmul_i2(A, qw)
        ref = dequant_matmul_i2_plain(A, qw)
        split = dequant_matmul_i2_split_plain(A, qw, sms=sms)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"edges dequant_matmul_i2 M={M}: two calls "
                                 f"differ")
        held(f"dequant_matmul_i2 M={M}", (out - ref).abs().max().item(), 0.0,
             out)
        held(f"dequant_matmul_i2_split M={M}",
             (out - split).abs().max().item(), 0.0, out)
    n_tiled = 0
    # the wgmma + TMA tiled instances: M tails of every token tile, N =
    # 192 (a ragged 128-row tile), uint4 K = 384 (the last ring slot's
    # second K group zero-filled) and int2 K = 4160 (a tail of 64 past the
    # last whole 512, three of that slot's four A boxes wholly past K)
    for fmt, K in (("uint4", 384), ("int2", 4160)):
        N = 192
        if fmt == "uint4":
            qw = _words(torch, gen, (N, K // 8))
            sc = (torch.rand((K // 128, N), generator=gen, device="cuda")
                  * 0.05).half()
            zr = torch.randint(0, 16, (K // 128, N), generator=gen,
                               device="cuda").half()
        else:
            qw = _words(torch, gen, (N, K // 16))
        for tile in FUSED_TILES[fmt][1:]:
            for M in (1, 33, 100, 130):
                if fmt == "uint4":
                    A = torch.randn((M, K), generator=gen,
                                    device="cuda").half()
                    out = dequant_matmul_u4(A, qw, sc, zr, tile=tile)
                    again = dequant_matmul_u4(A, qw, sc, zr, tile=tile)
                    ref = dequant_matmul_u4_plain(A, qw, sc, zr)
                else:
                    A = _int8(torch, gen, (M, K))
                    out = dequant_matmul_i2(A, qw, tile=tile)
                    again = dequant_matmul_i2(A, qw, tile=tile)
                    ref = dequant_matmul_i2_plain(A, qw)
                torch.cuda.synchronize()
                name = f"dequant_matmul_{fmt}_tiled {tile} M={M}"
                if not torch.equal(out, again):
                    raise AssertionError(f"edges {name}: two calls differ")
                if fmt == "uint4":
                    held(name, f16_ulps(torch, out, ref), 1.0, out)
                else:
                    held(name, (out - ref).abs().max().item(), 0.0, out)
                n_tiled += 1
    n_decode = 0
    lengths_ = (0, 1, 37, 64, 65, 200)
    B = len(lengths_)
    lengths = torch.tensor(lengths_, dtype=torch.int32, device="cuda")
    slots = torch.randperm(B + 1, generator=gen, device="cuda")[:B].to(
        torch.int32)
    bs, MB = 16, 16
    need = [-(-n // bs) for n in lengths_]
    blocks = 1 + sum(need)
    perm = torch.randperm(blocks - 1, generator=gen, device="cuda") + 1
    tables = torch.zeros((B, MB), dtype=torch.int32, device="cuda")
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at:at + n].to(torch.int32)
        at += n
    for D, H, Hkv, dt in ((256, 8, 2, torch.bfloat16),
                          (128, 16, 1, torch.bfloat16),
                          (128, 24, 2, torch.bfloat16),
                          (256, 16, 1, torch.float16),
                          (128, 8, 2, torch.float16)):
        q = torch.randn((B, H, D), generator=gen, device="cuda").half()
        for paged in (False, True):
            shape = (blocks, bs, Hkv, D) if paged else (B + 1, 256, Hkv, D)
            kf = torch.randn(shape, generator=gen, device="cuda") * 20
            vf = torch.randn(shape, generator=gen, device="cuda")
            for quant in (False, True):
                if quant:
                    (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
                    planes = ((k, 127), (v, -128), (ks, float("nan")),
                              (vs, float("nan")))
                else:
                    k, v = kf.to(dt), vf.to(dt)
                    planes = ((k, float("nan")), (v, float("nan")))
                for x, val in planes:
                    for b, n in enumerate(lengths_):
                        if not paged:
                            x[slots[b], n:] = val
                        else:
                            x[0] = val
                            if n % bs:
                                x[tables[b, n // bs], n % bs:] = val
                pools = (k, v, ks, vs) if quant else (k, v)
                if paged:
                    kern = (flash.flash_decode_paged_quant if quant
                            else flash.flash_decode_paged)
                    plain = (flash.flash_decode_paged_quant_plain if quant
                             else flash.flash_decode_paged_plain)
                    args = (q, *pools, tables, lengths)
                else:
                    kern = (flash.flash_decode_quant if quant
                            else flash.flash_decode)
                    plain = (flash.flash_decode_quant_plain if quant
                             else flash.flash_decode_plain)
                    args = (q, *pools, lengths, slots)
                out, again = kern(*args), kern(*args)
                ref = plain(*args)
                torch.cuda.synchronize()
                if not torch.equal(out, again):
                    raise AssertionError(f"edges {kern.__name__} D={D} H={H} "
                                         f"Hkv={Hkv}: two calls differ")
                err = (out.float() - ref.float()).abs().max().item()
                # K amplified 20x: f32 scores summed in other orders,
                # ~0.3% in a weight of outputs |.| < 5
                held(f"{kern.__name__} D={D} H={H} Hkv={Hkv} {dt}", err,
                     1e-2, out)
                n_decode += 1
    row = {"phase": "edges", "dense_cases": n_dense, "dequant_cases": 4,
           "dequant_tiled_cases": n_tiled, "decode_cases": n_decode,
           "worst_err_over_tol": worst}
    emit(row)
    return row


def check_flash_attention(torch, flush):
    """Kernel 4 at the main path's prompts (B = 1, H = 32, S = 256 / 512):
    Llama-2-7B's Hkv = 32 and BitNet's Llama-3-8B Hkv = 8. The yardstick
    is SDPA on K/V expanded to every head beforehand."""
    from bitblas_tpu_torch.kernels.flash import (flash_attention_fwd,
                                                 flash_attention_plain)
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    rows = []
    B, H, D = 1, 32, 128
    for S, Hkv in ((256, 32), (512, 32), (512, 8)):
        Q = torch.randn((B, S, H, D), generator=gen, device="cuda").half()
        K, V = (torch.randn((B, S, Hkv, D), generator=gen,
                            device="cuda").half() for _ in range(2))
        out = flash_attention_fwd(Q, K, V)
        ref = flash_attention_plain(Q, K, V)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        # P is rounded to f16 before the PV product (2^-11 relative per
        # weight), and the output is one f16 rounding: 1e-2 absolute on
        # outputs of magnitude < 4
        tol = 1e-2
        if not (err <= tol and torch.isfinite(out).all().item()):
            raise AssertionError(f"flash S={S} Hkv={Hkv}: max abs err {err} "
                                 f"> {tol}")
        qt = Q.transpose(1, 2).contiguous()
        kt, vt = (x.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
                  .contiguous() for x in (K, V))
        nbytes = 2 * B * S * (H + Hkv) * D * 2
        flops = 4.0 * B * H * D * S * (S + 1) / 2
        b_ms, b_by = bound(nbytes, flops)
        row = {
            "phase": "kernels", "kernel": "flash_attention_fwd",
            "B": B, "H": H, "Hkv": Hkv, "S": S, "D": D, "max_abs_err": err,
            "max_rel_err": err / ref.float().abs().max().item(), "tol": tol,
            "kernel_ms": time_ms(torch, lambda: flash_attention_fwd(Q, K, V),
                                 20, flush),
            "plain_ms": time_ms(torch, lambda: flash_attention_plain(Q, K, V),
                                5, flush),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), 20, flush),
            "stream_ms": time_ms(torch, _stream(torch, nbytes), 20, flush),
            "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        rows.append(row)
    return rows


DECODE_LENGTHS = (1, 37, 513, 1024)


def _stream(torch, nbytes: float):
    """A yardstick for the attention rows (`stream_ms`): one PyTorch
    reduction over a contiguous f16 buffer of the kernel's byte count, i.e.
    the time to read those bytes once under the same timing (L2 flushed
    before each launch)."""
    buf = torch.zeros(int(nbytes) // 2, dtype=torch.float16, device="cuda")
    return lambda: buf.sum()


def _decode_row(torch, name, out, ref, tol, timed, extra, flush,
                elementwise: bool = False):
    """Check a decode kernel's output against its plain version and time
    it: `timed` maps a column (kernel_ms, plain_ms, ...) to (fn, iters).
    `tol`: an absolute limit; `elementwise` holds each element to
    DECODE_TOL as well (decode_err)."""
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not (err <= tol and torch.isfinite(out).all().item()):
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    if elementwise:
        ratio = decode_err(out, ref)
        if not ratio <= 1.0:
            raise AssertionError(f"{name}: error {ratio} of its limit (max "
                                 f"abs {err})")
        extra = {**extra, "err_over_tol": ratio, "elementwise": DECODE_TOL}
    row = {"phase": "kernels", "kernel": name, **extra, "max_abs_err": err,
           "max_rel_err": err / ref.float().abs().max().item(), "tol": tol}
    for col, (fn, iters) in timed.items():
        row[col] = time_ms(torch, fn, iters, flush)
    emit(row)
    return row


def check_flash_decode(torch, flush):
    """Kernel 5 over the bf16 slot cache at Llama-2-7B's heads (H = Hkv =
    32) and BitNet's Llama-3-8B heads (H = 32, Hkv = 8, group 4)."""
    from bitblas_tpu_torch.kernels.flash import flash_decode, flash_decode_plain
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    rows = []
    B, H, D, Smax, rows_n = 4, 32, 128, 1024, 6
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    slots = torch.tensor([5, 0, 3, 1], dtype=torch.int32, device="cuda")
    for Hkv in (32, 8):
        q = torch.randn((B, H, D), generator=gen, device="cuda").half()
        kc = torch.randn((rows_n, Smax, Hkv, D), generator=gen,
                         device="cuda").to(torch.bfloat16)
        vc = torch.randn((rows_n, Smax, Hkv, D), generator=gen,
                         device="cuda").to(torch.bfloat16)
        for b in range(B):   # stale rows past each length: never read
            kc[slots[b], lengths[b]:] = float("nan")
            vc[slots[b], lengths[b]:] = float("nan")
        args = (q, kc, vc, lengths, slots)
        out = flash_decode(*args)
        ref = flash_decode_plain(*args)
        # yardstick: SDPA over the gathered caches, expanded to every head,
        # with a length mask (the gather itself is outside the timed call)
        kg, vg = (x[slots.long()].transpose(1, 2).half().nan_to_num()
                  .repeat_interleave(H // Hkv, dim=1) for x in (kc, vc))
        mask = (torch.arange(Smax, device="cuda")[None] < lengths[:, None]
                .long())[:, None, None, :]
        ltot = int(lengths.sum().item())
        nbytes = ltot * Hkv * D * 2 * 2 + 2 * B * H * D * 2
        b_ms, b_by = bound(nbytes, 4.0 * ltot * H * D)
        # f32 softmax both sides; one f16 rounding of |out| < 2
        rows.append(_decode_row(
            torch, "flash_decode", out, ref, 2e-3,
            {"kernel_ms": (lambda: flash_decode(*args), 20),
             "plain_ms": (lambda: flash_decode_plain(*args), 5),
             "library_ms": (lambda: F.scaled_dot_product_attention(
                 q[:, :, None], kg, vg, attn_mask=mask), 20),
             "stream_ms": (_stream(torch, nbytes), 20)},
            {"B": B, "H": H, "Hkv": Hkv, "Smax": Smax,
             "lengths": lengths.tolist(), "bound_ms": b_ms,
             "bound_by": b_by}, flush))
    return rows


def check_flash_decode_quant(torch, flush):
    """Kernel 6 at Llama-2-7B widths over the int8 slot cache; stale rows
    past each length hold extreme codes and NaN scales."""
    from bitblas_tpu_torch.kernels.flash import (flash_decode_quant,
                                                 flash_decode_quant_plain)
    from bitblas_tpu_torch.serving.kv_cache import quantize_kv
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    B, H, Hkv, D, Smax, rows_n = 4, 32, 32, 128, 1024, 6
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    slots = torch.tensor([5, 0, 3, 1], dtype=torch.int32, device="cuda")
    q = torch.randn((B, H, D), generator=gen, device="cuda").half()
    kc, ks = quantize_kv(torch.randn((rows_n, Smax, Hkv, D), generator=gen,
                                     device="cuda"))
    vc, vs = quantize_kv(torch.randn((rows_n, Smax, Hkv, D), generator=gen,
                                     device="cuda"))
    for b in range(B):
        kc[slots[b], lengths[b]:] = 127
        vc[slots[b], lengths[b]:] = -128
        ks[slots[b], lengths[b]:] = float("nan")
        vs[slots[b], lengths[b]:] = float("nan")
    args = (q, kc, vc, ks, vs, lengths, slots)
    out = flash_decode_quant(*args)
    ref = flash_decode_quant_plain(*args)
    # yardstick: SDPA over the gathered rows, dequantized beforehand
    s = slots.long()
    kg = (kc[s].float() * ks[s][..., None]).nan_to_num().transpose(1, 2) \
        .half()
    vg = (vc[s].float() * vs[s][..., None]).nan_to_num().transpose(1, 2) \
        .half()
    mask = (torch.arange(Smax, device="cuda")[None]
            < lengths[:, None].long())[:, None, None, :]
    ltot = int(lengths.sum().item())
    # live int8 codes + their f32 scales, q in, out out
    nbytes = ltot * Hkv * (2 * D + 2 * 4) + 2 * B * H * D * 2
    b_ms, b_by = bound(nbytes, 4.0 * ltot * H * D)
    # f32 softmax and products on both sides over the same codes; one f16
    # rounding of |out| < 2
    return _decode_row(
        torch, "flash_decode_quant", out, ref, 2e-3,
        {"kernel_ms": (lambda: flash_decode_quant(*args), 20),
         "plain_ms": (lambda: flash_decode_quant_plain(*args), 5),
         "library_ms": (lambda: F.scaled_dot_product_attention(
             q[:, :, None], kg, vg, attn_mask=mask), 20),
         "stream_ms": (_stream(torch, nbytes), 20)},
        {"B": B, "H": H, "Hkv": Hkv, "Smax": Smax,
         "lengths": list(DECODE_LENGTHS), "bound_ms": b_ms,
         "bound_by": b_by}, flush)


def check_flash_decode_paged(torch, flush, quant: bool, qdtype=None):
    """Kernel 7 (bf16) or 8 (int8) at Llama-2-7B widths over a block pool
    of 16-row pages through a permuted table; the reserved block 0 and the
    rows past each length in the last page are NaN (NaN scales for int8),
    and table entries past the live pages are 0. Queries float16, or
    `qdtype` (bfloat16: a bfloat16 model's)."""
    from bitblas_tpu_torch.kernels import flash
    from bitblas_tpu_torch.serving import kv_cache
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9 + quant + (qdtype is not None))
    qdtype = qdtype or torch.float16
    B, H, Hkv, D, bs, MB = 4, 32, 32, 128, 16, 64
    need = [-(-n // bs) for n in DECODE_LENGTHS]
    blocks = 1 + sum(need) + 27
    perm = torch.randperm(blocks - 1, generator=gen, device="cuda") + 1
    tables = torch.zeros((B, MB), dtype=torch.int32, device="cuda")
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at:at + n].to(torch.int32)
        at += n
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(qdtype)
    kf, vf = (torch.randn((blocks, bs, Hkv, D), generator=gen, device="cuda")
              for _ in range(2))
    if quant:
        (k, ks), (v, vs) = kv_cache.quantize_kv(kf), kv_cache.quantize_kv(vf)
        pools = (k, v, ks, vs)
        stale = ((k, 127), (v, -128), (ks, float("nan")),
                 (vs, float("nan")))
        kernel, plain = flash.flash_decode_paged_quant, \
            flash.flash_decode_paged_quant_plain
        gather = kv_cache.decode_attention_paged_quant
        kd = (k.float() * ks[..., None])
        vd = (v.float() * vs[..., None])
    else:
        k, v = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        pools = (k, v)
        stale = ((k, float("nan")), (v, float("nan")))
        kernel, plain = flash.flash_decode_paged, \
            flash.flash_decode_paged_plain
        gather = kv_cache.decode_attention_paged
        kd, vd = k, v
    for x, val in stale:
        x[0] = val
        for b, n in enumerate(DECODE_LENGTHS):
            if n % bs:
                x[tables[b, n // bs], n % bs:] = val
    args = (q, *pools, tables, lengths)
    out = kernel(*args)
    ref = plain(*args)
    # yardstick: SDPA over the rows gathered through the tables beforehand
    t = tables.long()
    kg, vg = (x[t].reshape(B, MB * bs, Hkv, D).float().nan_to_num()
              .transpose(1, 2).to(qdtype) for x in (kd, vd))
    mask = (torch.arange(MB * bs, device="cuda")[None]
            < lengths[:, None].long())[:, None, None, :]
    ltot = int(lengths.sum().item())
    per_row = 2 * D + 2 * 4 if quant else 2 * D * 2
    # live rows (+ scales), the live table entries, q in, out out
    nbytes = ltot * Hkv * per_row + sum(need) * 4 + 2 * B * H * D * 2
    b_ms, b_by = bound(nbytes, 4.0 * ltot * H * D)
    name = kernel.__name__
    # f32 softmax and products on both sides over the same stored values;
    # one rounding of |out| < 2 to q's type (f16 2^-10, bf16 2^-7), and,
    # bfloat16, DECODE_TOL element by element
    bf16 = qdtype == torch.bfloat16
    return _decode_row(
        torch, name, out, ref, 2 * BF16 if bf16 else 2e-3,
        {"kernel_ms": (lambda: kernel(*args), 20),
         "plain_ms": (lambda: plain(*args), 5),
         "gather_ms": (lambda: gather(*args, num_heads=H, use_flash=False),
                       5),
         "library_ms": (lambda: F.scaled_dot_product_attention(
             q[:, :, None], kg, vg, attn_mask=mask), 20),
         "stream_ms": (_stream(torch, nbytes), 20)},
        {"B": B, "H": H, "Hkv": Hkv, "block_size": bs, "max_blocks": MB,
         "q": str(qdtype).split(".")[-1],
         "lengths": list(DECODE_LENGTHS), "bound_ms": b_ms,
         "bound_by": b_by}, flush, elementwise=bf16)


# -- bfloat16 and the sliding window in kernels 4-8 (Mistral-7B-v0.1) -------

MISTRAL_WINDOW = 4096        # Mistral-7B-v0.1's sliding_window
BF16 = 2.0 ** -8             # bfloat16's relative rounding
# The bfloat16 and windowed attention rows keep their absolute limits and
# hold each output element to its own size as well (testing.attention_err):
# one ulp of the output type (ATTN_ULP) of |ref| plus a floor of the row's
# rms, 4 ulps for the prefill (P rounds to Q's type before P V: about 2^-9
# of the row's rms a row in bfloat16, 2^-7 at the worst of 33M elements)
# and 1 ulp for the decode kernels (float32 P on both sides). An absolute
# limit alone lets a band row, which averages up to W keys and is small,
# be wrong by its own size.
PREFILL_TOL = "ulp |ref| + 4 ulp rms(row)"
DECODE_TOL = "ulp |ref| + ulp rms(row)"


def prefill_err(out, ref) -> float:
    """Kernel 4's output against its plain version, in units of its limit
    (at most 1 passes)."""
    from bitblas_tpu_torch.testing import ATTN_ULP, attention_err
    u = ATTN_ULP[out.dtype]
    return attention_err(out, ref, u, 4 * u)


def decode_err(out, ref) -> float:
    """A decode kernel's output against its plain version, in units of
    its limit (at most 1 passes)."""
    from bitblas_tpu_torch.testing import ATTN_ULP, attention_err
    u = ATTN_ULP[out.dtype]
    return attention_err(out, ref, u, u)


def band_keys(S: int, window) -> int:
    """sum over the S rows of a causal prefill of the keys each attends:
    min(i + 1, window)."""
    W = S if window is None else min(window, S)
    return W * (W + 1) // 2 + (S - W) * W


def band_mask(torch, S: int, window):
    """[S, S] boolean: key j <= row i and j > i - window (SDPA's
    explicit mask for the library yardstick)."""
    keep = torch.ones((S, S), dtype=torch.bool, device="cuda").tril()
    return keep if window is None else keep.triu(1 - window)


def check_flash_attention_bf16_window(torch, flush):
    """Kernel 4 at bfloat16 (B = 1, H = 32, Hkv = 8, S = 512, no window:
    Mistral's heads) and with Mistral's window (S = 8192, window 4096,
    bfloat16 and float16). The bound counts the band's bytes (Q, K, V
    read once, O written once) and the band's products, 4 H D sum_i
    min(i + 1, window); the yardstick is SDPA on K/V expanded to every
    head, causal, or with the band as an explicit boolean mask."""
    from bitblas_tpu_torch.kernels.flash import (flash_attention_fwd,
                                                 flash_attention_plain)
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    rows = []
    B, H, Hkv, D = 1, 32, 8, 128
    for dtype, S, window in (("bfloat16", 512, None),
                             ("bfloat16", 8192, MISTRAL_WINDOW),
                             ("float16", 8192, MISTRAL_WINDOW)):
        dt = getattr(torch, dtype)
        Q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
        K, V = (torch.randn((B, S, Hkv, D), generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        out = flash_attention_fwd(Q, K, V, window=window)
        ref = flash_attention_plain(Q, K, V, window)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ratio = prefill_err(out, ref)
        # P rounds to Q's type before P V and the output rounds once:
        # float16 1e-2 on outputs |.| < 4 (the windowless rows' limit),
        # bfloat16 2^-5 (two roundings of 2^-8 on |.| < 4)
        tol = 8 * BF16 if dtype == "bfloat16" else 1e-2
        if not (err <= tol and ratio <= 1.0):
            raise AssertionError(f"flash {dtype} S={S} window={window}: "
                                 f"max abs err {err} (limit {tol}), "
                                 f"{ratio} of its element-wise limit")
        qt = Q.transpose(1, 2).contiguous()
        kt, vt = (x.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
                  .contiguous() for x in (K, V))
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True)
        else:
            mask = band_mask(torch, S, window)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask)
        nbytes = 2 * B * S * (H + Hkv) * D * 2
        flops = 4.0 * B * H * D * band_keys(S, window)
        b_ms, b_by = bound(nbytes, flops)
        row = {
            "phase": "kernels", "kernel": "flash_attention_fwd",
            "dtype": dtype, "window": window, "B": B, "H": H, "Hkv": Hkv,
            "S": S, "D": D, "max_abs_err": err,
            "max_rel_err": err / ref.float().abs().max().item(),
            "tol": tol, "err_over_tol": ratio, "elementwise": PREFILL_TOL,
            "kernel_ms": time_ms(torch, lambda: flash_attention_fwd(
                Q, K, V, window=window), 20, flush),
            "plain_ms": time_ms(torch, lambda: flash_attention_plain(
                Q, K, V, window), 3, flush),
            "library_ms": time_ms(torch, lib, 10, flush),
            "stream_ms": time_ms(torch, _stream(torch, nbytes), 20, flush),
            "bound_ms": b_ms, "bound_by": b_by}
        del ref
        torch.cuda.empty_cache()
        emit(row)
        rows.append(row)
    return rows


WINDOW_LENGTHS = (1, 37, 4097, 8000)


def check_flash_decode_window(torch, flush, quant: bool):
    """Kernel 5 (bf16 slot cache) or 6 (int8) at Mistral's heads (B = 4,
    H = 32, Hkv = 8, D = 128), bfloat16 queries, window 4096, lengths
    1 / 37 / 4097 / 8000 over Smax = 8192; rows past each length NaN (int8:
    extreme codes, NaN scales). The bound counts min(len, window) keys a
    sequence; the yardstick is SDPA over the gathered caches with the
    window as a boolean mask."""
    from bitblas_tpu_torch.kernels import flash
    from bitblas_tpu_torch.serving.kv_cache import quantize_kv
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22 + quant)
    B, H, Hkv, D, Smax, rows_n = 4, 32, 8, 128, 8192, 6
    W = MISTRAL_WINDOW
    lengths = torch.tensor(WINDOW_LENGTHS, dtype=torch.int32, device="cuda")
    slots = torch.tensor([5, 0, 3, 1], dtype=torch.int32, device="cuda")
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    kf, vf = (torch.randn((rows_n, Smax, Hkv, D), generator=gen,
                          device="cuda") for _ in range(2))
    if quant:
        (kc, ks), (vc, vs) = quantize_kv(kf), quantize_kv(vf)
        caches = (kc, vc, ks, vs)
        stale = ((kc, 127), (vc, -128), (ks, float("nan")),
                 (vs, float("nan")))
        kernel, plain = flash.flash_decode_quant, flash.flash_decode_quant_plain
        kd, vd = kc.float() * ks[..., None], vc.float() * vs[..., None]
        per_key = Hkv * (2 * D + 2 * 4)
    else:
        kc, vc = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        caches = (kc, vc)
        stale = ((kc, float("nan")), (vc, float("nan")))
        kernel, plain = flash.flash_decode, flash.flash_decode_plain
        kd, vd = kc, vc
        per_key = Hkv * D * 2 * 2
    del kf, vf
    for x, val in stale:
        for b in range(B):
            x[slots[b], lengths[b]:] = val
    args = (q, *caches, lengths, slots)
    out = kernel(*args, window=W)
    ref = plain(*args, W)
    s = slots.long()
    kg, vg = (x[s].float().nan_to_num().transpose(1, 2).to(torch.bfloat16)
              .repeat_interleave(H // Hkv, dim=1) for x in (kd, vd))
    pos = torch.arange(Smax, device="cuda")[None]
    mask = ((pos < lengths[:, None].long())
            & (pos >= lengths[:, None].long() - W))[:, None, None, :]
    live = sum(min(n, W) for n in WINDOW_LENGTHS)
    nbytes = live * per_key + 2 * B * H * D * 2
    b_ms, b_by = bound(nbytes, 4.0 * live * H * D)
    # f32 softmax both sides; one bfloat16 rounding of |out| < 2 (2^-7),
    # and DECODE_TOL element by element
    return _decode_row(
        torch, kernel.__name__, out, ref, 2 * BF16,
        {"kernel_ms": (lambda: kernel(*args, window=W), 20),
         "plain_ms": (lambda: plain(*args, W), 5),
         "library_ms": (lambda: F.scaled_dot_product_attention(
             q[:, :, None], kg, vg, attn_mask=mask), 20),
         "stream_ms": (_stream(torch, nbytes), 20)},
        {"B": B, "H": H, "Hkv": Hkv, "Smax": Smax, "q": "bfloat16",
         "window": W, "lengths": list(WINDOW_LENGTHS), "bound_ms": b_ms,
         "bound_by": b_by}, flush, elementwise=True)


def check_window_edges(torch):
    """Untimed, against the plain versions, two calls bit-equal: kernel 4
    at S = 64 / 128 / 8192, float16 and bfloat16, windows 1, 63, 64, 65
    and >= S (63 and 64 give rows whose first visited tile is all
    masked), a window >= S bit-equal to the windowless call; kernels 5 and
    6 with float16 and bfloat16 queries, windows 1, 63, 64, 65 and >=
    Smax, lengths window - 1, window and window + 1 (and 0, 1, Smax) over
    Smax = 8192 on 132-key-apart splits' plan (decode_span: the splits
    past a length hold no live key), NaN past each length, against the
    single-pass and the split plain versions, a window >= Smax bit-equal
    to the windowless call."""
    from bitblas_tpu_torch.kernels import flash
    from bitblas_tpu_torch.kernels.scratch import sm_count
    from bitblas_tpu_torch.serving.kv_cache import quantize_kv
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    worst, n_prefill, n_decode, dead = {}, 0, 0, 0

    def held(name, out, ref, tol, ratio):
        err = (out.float() - ref.float()).abs().max().item()
        if not (err <= tol and ratio <= 1.0
                and torch.isfinite(out).all().item()):
            raise AssertionError(f"window edges {name}: max abs err {err} "
                                 f"(limit {tol}), {ratio} of its "
                                 f"element-wise limit")
        key = name.split(" ")[0]
        worst[key] = max(worst.get(key, 0.0), ratio)

    for S in (64, 128, 8192):
        H, Hkv = (8, 2) if S == 8192 else (4, 2)
        for dtype in ("float16", "bfloat16"):
            dt = getattr(torch, dtype)
            Q = torch.randn((1, S, H, 128), generator=gen, device="cuda") \
                .to(dt)
            K = (torch.randn((1, S, Hkv, 128), generator=gen, device="cuda")
                 * 3).to(dt)
            V = torch.randn((1, S, Hkv, 128), generator=gen, device="cuda") \
                .to(dt)
            full = flash.flash_attention_fwd(Q, K, V)
            for window in (1, 63, 64, 65, S, S + 1):
                out = flash.flash_attention_fwd(Q, K, V, window=window)
                again = flash.flash_attention_fwd(Q, K, V, window=window)
                ref = flash.flash_attention_plain(Q, K, V, min(window, S))
                torch.cuda.synchronize()
                if not torch.equal(out, again):
                    raise AssertionError(f"window edges prefill S={S} "
                                         f"{dtype} w={window}: two calls "
                                         f"differ")
                if window >= S and not torch.equal(out, full):
                    raise AssertionError(f"window edges prefill S={S} "
                                         f"{dtype} w={window} >= S: not "
                                         f"the windowless output")
                held(f"flash_attention_fwd S={S} {dtype} w={window}", out,
                     ref, 8 * BF16 if dtype == "bfloat16" else 1e-2,
                     prefill_err(out, ref))
                n_prefill += 1
            del Q, K, V, full
            torch.cuda.empty_cache()

    Smax, H, Hkv = 8192, 8, 2
    sms = sm_count(torch.device("cuda"))
    for quant in (False, True):
        for window in (1, 63, 64, 65, Smax):
            lens = sorted({0, 1, max(window - 1, 1), window,
                           min(window + 1, Smax), 5000, Smax})
            B = len(lens)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            slots = torch.randperm(B + 1, generator=gen, device="cuda")[:B] \
                .to(torch.int32)
            kf = torch.randn((B + 1, Smax, Hkv, 128), generator=gen,
                             device="cuda") * 20
            vf = torch.randn((B + 1, Smax, Hkv, 128), generator=gen,
                             device="cuda")
            if quant:
                (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
                caches = (k, v, ks, vs)
                stale = ((k, 127), (v, -128), (ks, float("nan")),
                         (vs, float("nan")))
                kern, plain = flash.flash_decode_quant, \
                    flash.flash_decode_quant_plain
            else:
                k, v = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
                caches = (k, v)
                stale = ((k, float("nan")), (v, float("nan")))
                kern, plain = flash.flash_decode, flash.flash_decode_plain
            del kf, vf
            for x, val in stale:
                for b in range(B):
                    x[slots[b], lens[b]:] = val
            span = flash.decode_span(Smax, window if window < Smax
                                     else None)
            chunk, splits = flash.plan_splits(span, B, Hkv, sms)
            for n in lens:   # splits past the length: no live key
                base = max(n - window, 0) // 64 * 64
                dead += sum(1 for sp in range(splits)
                            if base + sp * chunk >= n)
            for qdt in (torch.float16, torch.bfloat16):
                q = torch.randn((B, H, 128), generator=gen,
                                device="cuda").to(qdt)
                args = (q, *caches, lengths, slots)
                out = kern(*args, window=window)
                again = kern(*args, window=window)
                ref = plain(*args, window)
                scales = dict(k_scale=caches[2], v_scale=caches[3]) \
                    if quant else {}
                split = flash.flash_decode_split_plain(
                    q, caches[0], caches[1], lengths, slots, window=window,
                    sms=sms, **scales)
                torch.cuda.synchronize()
                if not torch.equal(out, again):
                    raise AssertionError(f"window edges {kern.__name__} "
                                         f"w={window} {qdt}: two calls "
                                         f"differ")
                if window >= Smax and not torch.equal(out, kern(*args)):
                    raise AssertionError(f"window edges {kern.__name__} "
                                         f"w={window}: not the windowless "
                                         f"output")
                if not torch.equal(out[0], torch.zeros_like(out[0])):
                    raise AssertionError("window edges: length 0 is not 0")
                # K amplified 20x: f32 scores in other orders (1e-2, the
                # windowless decode edges' limit) and, bfloat16, one
                # rounding of |out| < 4
                tol = 1e-2 + (4 * BF16 if qdt == torch.bfloat16 else 0.0)
                held(f"{kern.__name__} w={window} {qdt}", out, ref, tol,
                     decode_err(out, ref))
                held(f"{kern.__name__}_split w={window} {qdt}", out, split,
                     tol, decode_err(out, split))
                n_decode += 1
            del caches, stale
            torch.cuda.empty_cache()
    if dead == 0:
        raise AssertionError("window edges: no split without a live key")
    row = {"phase": "window_edges", "prefill_cases": n_prefill,
           "decode_cases": n_decode, "splits_without_live_key": dead,
           "elementwise": {"prefill": PREFILL_TOL, "decode": DECODE_TOL},
           "worst_err_over_tol": worst}
    emit(row)
    return row


def mistral_7b(num_layers: int, window=MISTRAL_WINDOW):
    from bitblas_tpu_torch.models.quant_llama import LlamaConfig
    # mistralai/Mistral-7B-v0.1 config.json widths (sliding_window 4096,
    # torch_dtype bfloat16); uint4 GPTQ, group 128, original zeros (the
    # TheBloke/Mistral-7B-v0.1-GPTQ layout), bfloat16 activations
    return LlamaConfig(hidden_size=4096, intermediate_size=14336,
                       num_heads=32, num_kv_heads=8, num_layers=num_layers,
                       vocab_size=32000, group_size=128,
                       act_dtype="bfloat16", rope_theta=10000.0,
                       sliding_window=window, rms_norm_eps=1e-5)


class CpuWeightMemo:
    """While installed, the plain versions' dense weight of a CPU
    projection (`dequantize_fmt_hopper`, and uint4 x f16's
    `dequantize_hopper`: the same functions and the same bits) is decoded
    once and kept, so the CPU reference does not decode every weight
    again at every step. Card tensors pass through."""

    NAMES = ("dequantize_fmt_hopper", "dequantize_hopper")

    def __init__(self):
        from bitblas_tpu_torch.kernels import dequant_matmul, materialize
        self.mods = (dequant_matmul, materialize)
        self.orig = {n: getattr(dequant_matmul, n) for n in self.NAMES}
        self.memo = {}

    def __enter__(self):
        memo = self.memo

        def cached(name, orig):
            def fn(qweight, *args, **kw):
                if qweight.device.type != "cpu" or kw:
                    return orig(qweight, *args, **kw)
                key = (name, qweight.data_ptr(), *(a.data_ptr() if hasattr(
                    a, "data_ptr") else a for a in args))
                if key not in memo:
                    memo[key] = orig(qweight, *args)
                return memo[key]
            return fn

        for name, orig in self.orig.items():
            fn = cached(name, orig)
            for m in self.mods:
                if hasattr(m, name):
                    setattr(m, name, fn)
        return self

    def __exit__(self, *exc):
        for name, orig in self.orig.items():
            for m in self.mods:
                if hasattr(m, name):
                    setattr(m, name, orig)
        self.memo.clear()


# The Mistral reference's tolerance on hidden states and logits: bfloat16
# activations round each projection's output to 2^-8; the card's sums
# (other orders, split-K, cuBLAS) flip some of those roundings, a few of
# them per value through 2 layers: 3e-2 of the largest (about eight
# bfloat16 roundings; the float16 reference holds 2e-2 at 2^-11).
MISTRAL_REF_TOL = 3e-2
REFERENCE_WINDOW = 256       # the reference's window (reduced from 4096)
# the reference's depth: 1 (2 until the Mixtral phases joined the run,
# whose time its CPU side, ~70 s a layer, then pushed towards the limit)
MISTRAL_REF_LAYERS = 1


def check_reference_mistral(torch, counters):
    """MISTRAL_REF_LAYERS at Mistral-7B-v0.1's widths, bfloat16, the
    window reduced to 256 (the CPU plain reference over prompts past 4096 keys costs too
    much), card against the same weights on the CPU plain path: prefill
    in bucket 512 (the banded flash kernel) and teacher-forced decode
    steps; the token engine on bf16 and int8 KV; the paged engine on bf16
    and int8 (the window through the masked gather); prefill_chunk = 64;
    kv_ring on both caches. Prompts of 300-500 tokens cross the window.
    Then a windowless bfloat16 model on the paged engine, so that kernels
    7 and 8 launch on bfloat16 queries."""
    from bitblas_tpu_torch.kernels import flash
    from bitblas_tpu_torch.models.quant_llama import QuantLlama
    from bitblas_tpu_torch.serving import kv_cache
    by_name = {c.__name__: c for c in counters}
    for c in counters:
        c.launches = 0
        if hasattr(c, "variant_launches"):
            c.variant_launches.clear()
    gathers = (kv_cache.decode_attention_paged.window_gathers,
               kv_cache.decode_attention_paged_quant.window_gathers)
    t0 = time.perf_counter()
    cfg = mistral_7b(MISTRAL_REF_LAYERS, window=REFERENCE_WINDOW)
    # one memo a CPU model: a later model's buffers may reuse the freed
    # addresses of an earlier one's
    with CpuWeightMemo():
        gpu, cpu = _card_and_cpu(
            torch, lambda **kw: QuantLlama(cfg, **kw), seed=31)
        reference_steps(torch, cfg, gpu, cpu, "reference_mistral",
                        hidden_tol=MISTRAL_REF_TOL)
        common = dict(rel_tol=MISTRAL_REF_TOL, lengths=(300, 400, 500),
                      budgets=(4, 6, 5))
        for tag, kw in (("_mistral", {}),
                        ("_mistral_kv_quant", {"kv_quant": True}),
                        ("_mistral_chunk", {"engine_kw": {
                            "prefill_chunk": 64}}),
                        ("_mistral_ring", {"engine_kw": {
                            "prefill_chunk": 64, "kv_ring": True}}),
                        ("_mistral_ring_quant", {"kv_quant": True,
                                                 "engine_kw": {
                                                     "prefill_chunk": 64,
                                                     "kv_ring": True}})):
            compare_engines(torch, cfg, gpu, cpu, tag=tag, **common, **kw)
        for quant in (False, True):
            compare_paged(torch, cfg, gpu, cpu, kv_quant=quant,
                          rel_tol=MISTRAL_REF_TOL, tag="_mistral")
        del gpu, cpu
        torch.cuda.empty_cache()
        windowed = {
            "flash_attention_fwd bfloat16 window": by_name[
                "flash_attention_fwd"].variant_launches.get(
                    "bfloat16 window", 0),
            "flash_decode bfloat16 window": by_name[
                "flash_decode"].variant_launches.get("bfloat16 window", 0),
            "flash_decode_quant bfloat16 window": by_name[
                "flash_decode_quant"].variant_launches.get(
                    "bfloat16 window", 0),
            "paged window gathers": kv_cache.decode_attention_paged
            .window_gathers - gathers[0],
            "paged_quant window gathers": kv_cache
            .decode_attention_paged_quant.window_gathers - gathers[1]}
    nw = mistral_7b(MISTRAL_REF_LAYERS, window=None)
    with CpuWeightMemo():
        gpu, cpu = _card_and_cpu(
            torch, lambda **kw: QuantLlama(nw, **kw), seed=33)
        for quant in (False, True):
            compare_paged(torch, nw, gpu, cpu, kv_quant=quant,
                          rel_tol=MISTRAL_REF_TOL, tag="_mistral_nowindow")
        del gpu, cpu
        torch.cuda.empty_cache()
    windowed.update({
        f"{name} bfloat16": by_name[name].variant_launches.get("bfloat16", 0)
        for name in ("flash_decode_paged", "flash_decode_paged_quant")})
    if min(windowed.values()) <= 0:
        raise AssertionError(f"reference_mistral: a route was not taken: "
                             f"{windowed}")
    emit({"phase": "reference_mistral_routes", "layers": MISTRAL_REF_LAYERS,
          "window": REFERENCE_WINDOW, "reduced": {
              "window": f"{MISTRAL_WINDOW} -> {REFERENCE_WINDOW}: the CPU "
                        f"plain reference over prompts past 4096 keys "
                        f"costs too much",
              "layers": f"32 -> {MISTRAL_REF_LAYERS}"},
          "launches": windowed, "seconds": time.perf_counter() - t0})
    return windowed


MISTRAL_PROMPTS = (1000, 3000, 4500, 6000)
MISTRAL_MAX_SEQ = 8192
MISTRAL_CHUNK = 256


def mistral_serving_model(torch):
    """32 layers at Mistral-7B-v0.1's widths, W4 g128 original zeros,
    bfloat16 activations, window 4096, random weights drawn on the card
    from a seed, an LMHead of vocab 32000, the four prompts (two decode
    past the window), max_seq_len 8192."""
    import numpy as np
    from bitblas_tpu_torch.models.hf_import import LMHead
    from bitblas_tpu_torch.models.quant_llama import QuantLlama

    t0 = time.perf_counter()
    cfg = mistral_7b(32)
    model = QuantLlama(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    V, Hd = cfg.vocab_size, cfg.hidden_size
    head = LMHead(
        embed=(torch.randn((V, Hd), generator=gen, device="cuda") * 0.05
               ).half(),
        final_norm=torch.ones(Hd, device="cuda"),
        lm_head=torch.randn((V, Hd), generator=gen, device="cuda") * 0.05,
        norm_eps=cfg.rms_norm_eps, device="cuda")
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, n).astype(np.int32)
               for n in MISTRAL_PROMPTS]
    packed = sum(t.numel() * t.element_size()
                 for n, t in model.named_buffers() if "qweight" in n or
                 "scales" in n or "zeros" in n)
    return {"cfg": cfg, "model": model, "head": head, "prompts": prompts,
            "pair": [], "init_s": time.perf_counter() - t0,
            "name": "Mistral-7B-v0.1 widths, W4 g128, bf16, window 4096",
            "weight_bytes": packed, "max_seq_len": MISTRAL_MAX_SEQ,
            "ring_rows": 4352}   # ring_capacity(4096, 256)


def mistral_phases(torch, counters, flush):
    """`--mistral`: the Mistral-7B-v0.1 slice alone: kernels 4-8's
    bfloat16 and windowed rows, the window edges, reference_mistral and
    the three 32-layer serve phases."""
    check_flash_attention_bf16_window(torch, flush)
    for quant in (False, True):
        check_flash_decode_window(torch, flush, quant=quant)
        check_flash_decode_paged(torch, flush, quant=quant,
                                 qdtype=torch.bfloat16)
    check_window_edges(torch)
    check_reference_mistral(torch, counters)
    routes = RouteRecorder()
    ctx = mistral_serving_model(torch)
    for phase in MISTRAL_PHASES:
        with routes:
            serve(torch, ctx, counters, *phase, routes=routes)
    del ctx
    torch.cuda.empty_cache()


def llama2_7b(num_layers: int, hidden: int = 4096, inter: int = 11008,
              heads: int = 32):
    from bitblas_tpu_torch.models.quant_llama import LlamaConfig
    # meta-llama/Llama-2-7b-hf config.json widths; uint4 GPTQ, group 128
    return LlamaConfig(hidden_size=hidden, intermediate_size=inter,
                       num_heads=heads, num_kv_heads=heads,
                       num_layers=num_layers, vocab_size=32000,
                       group_size=128, rms_norm_eps=1e-5)


def bitnet_llama3_8b(num_layers: int):
    from bitblas_tpu_torch.models.quant_llama import LlamaConfig
    # HF1BitLLM/Llama3-8B-1.58-100B-tokens config.json widths; every
    # projection a ternary W2A8 BitLinear
    return LlamaConfig(hidden_size=4096, intermediate_size=14336,
                       num_heads=32, num_kv_heads=8, num_layers=num_layers,
                       vocab_size=128256, rope_theta=500000.0,
                       rms_norm_eps=1e-5)


def _card_and_cpu(torch, make, seed: int):
    """The same weights on the card and on the CPU: drawn on the card, the
    CPU model built with another seed and loaded from them."""
    gpu = make(device="cuda", seed=seed)
    cpu = make(device="cpu", seed=seed + 1)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    return gpu, cpu


def check_reference(torch):
    """One layer at full width: the card's path vs the plain CPU path on
    the same weights (prefill at bucket 512 -> flash and the materialize
    route; 4 decode steps), then the token and paged engines. One layer
    keeps the run within its time (the CPU side is its cost): the walk
    over several layers' cache rows is held by the 2-layer references of
    the GPTQ import, BitNet and Mistral (token and paged engines)."""
    from bitblas_tpu_torch.models.quant_llama import QuantLlama
    cfg = llama2_7b(1)
    # the CPU decodes each projection's weight once (CpuWeightMemo), not at
    # every call: most of this phase's time before it was kept
    with CpuWeightMemo():
        gpu, cpu = _card_and_cpu(
            torch, lambda **kw: QuantLlama(cfg, **kw), seed=11)
        reference_steps(torch, cfg, gpu, cpu, "reference")
        compare_engines(torch, cfg, gpu, cpu)
        compare_engines(torch, cfg, gpu, cpu, kv_quant=True)
        compare_paged(torch, cfg, gpu, cpu, kv_quant=False)
        compare_paged(torch, cfg, gpu, cpu, kv_quant=True)
        del gpu, cpu
        torch.cuda.empty_cache()


# The BitNet reference's limits on logits relative to the largest, fixed
# from `python3 chip_smoke.py --bitnet-readings` (five seeds; NVIDIA H100
# 80GB HBM3, 700 W; PERF.md, "BitNet reference limit"). Teacher-forced
# steps: rms error <= 0.030, above every correct reading (card vs CPU and
# the CPU's own floor, <= 0.0276) and below every reading of the control
# that rounds activations to bfloat16 before their quantization
# (>= 0.0324); max error <= 0.036, above every correct reading (<=
# 0.0333). Token engine, per step: max error <= 0.055 (correct readings <=
# 0.0507). Greedy tokens are compared where the CPU's top-2 margin
# exceeds the max limit (decided): at least 20 of the 69 teacher-forced
# rows (readings: 26-34) and 3 engine steps (readings: 4-14).
BITNET_LOGIT_RMS = 0.030
BITNET_LOGIT_MAX = 0.036
BITNET_ENGINE_MAX = 0.055
BITNET_MIN_DECIDED = (20, 3)
# reference_bitnet_3b's limit on hidden states relative to the largest,
# from `python3 chip_smoke.py --bitnet-3b-readings` (2 layers at b1.58-3B's
# widths, seeds 41-43; NVIDIA H100 80GB HBM3, 700 W): the card against the
# CPU reads at most 0.0236 (prefill and decode hidden states), the CPU
# against itself with the plain masked softmax 0.0216; 0.03 sits above
# both. After 2 layers the bfloat16 glue-fault controls read 0.019-0.032
# max and 0.021-0.027 rms, inside or just past the card's spread: neither
# this limit nor the BitNet logit limits above reject them. After the
# first layer they stand apart, so BITNET_3B_LAYER1_RMS holds the
# prefill's hidden states there: rms error over rms, at reference_bitnet_3b's
# own inputs and two other weight seeds (S = 256 and 512), the card
# against the CPU <= 0.0098 (0.0096 / 0.0090 at the reference's inputs),
# the CPU's own floor <= 0.0092, the controls >= 0.0126 (each BitLinear's
# output rounded to bfloat16) and >= 0.0160 (activations rounded to
# bfloat16 before their quantization).
BITNET_3B_HIDDEN = 0.03
BITNET_3B_LAYER1_RMS = 0.011
# The reference's depth: 1 layer (the limits above were read at 2), cut to
# pay for the multi-GPU phases. Its fault detection is the first layer's
# (BITNET_3B_LAYER1_RMS, unchanged); the 2-layer limits rejected no
# control.
BITNET_3B_REF_LAYERS = 1


def check_bitnet_reference(torch, counters):
    """2 BitNet layers at Llama-3-8B widths, card against CPU: each
    BitLinear of the first layer on one input, prefill in bucket 512 (so
    the card takes weight_decode_int8 + torch._int_mm), teacher-forced
    decode steps through dequant_matmul_i2, and the token engine with four
    greedy requests.

    Card and CPU run the same Python glue, so what this can catch is what
    runs on the card alone. A BitLinear is IEEE-exact on both (float32
    absmax, one rounding per quantized code, exact int32 sums, a float32
    rescale): it must agree bit for bit at M = 4 (fused kernel) and M =
    512 (materialize route). Through the model it cannot: every
    projection re-quantizes its input per token, so an f16 ulp of
    difference upstream moves some codes by a whole step of max|x| / 127,
    and two correct computations differ by a few % of the largest logit
    (the CPU's own floor, two softmax paths, is reported beside); the
    logits are held to the fixed limits above."""
    from bitblas_tpu_torch.models.bitnet import BitNetLlama
    cfg = bitnet_llama3_8b(2)
    gpu, cpu = _card_and_cpu(
        torch, lambda **kw: BitNetLlama(cfg, **kw), seed=21)
    heads = _reference_heads(torch, cfg)
    for c in counters:
        c.launches = 0
    bitlinear_exact(torch, gpu, cpu)
    reference_steps(torch, cfg, gpu, cpu, "reference_bitnet", heads)
    launches = {c.__name__: c.launches for c in counters}
    if min(launches[k] for k in ("dequant_matmul_i2", "weight_decode_int8",
                                 "flash_attention_fwd", "flash_decode")) <= 0:
        raise AssertionError(f"reference_bitnet: a kernel was not launched: "
                             f"{launches}")
    compare_engines(torch, cfg, gpu, cpu, tag="_bitnet", heads=heads,
                    rel_tol=BITNET_ENGINE_MAX,
                    min_decided=BITNET_MIN_DECIDED[1])
    del gpu, cpu
    torch.cuda.empty_cache()


def bitlinear_exact(torch, gpu, cpu) -> None:
    """Each projection of the first layer on the same float16 input
    (N(0, 1)), card against CPU, at M = 4 and 512: equal bit for bit."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(7)
    for name, proj in gpu.layers[0].projs.items():
        for M in (4, 512):
            x = torch.randn((1, M, proj.in_features), generator=gen).half()
            a = proj(x.to("cuda")).cpu()
            b = cpu.layers[0].projs[name](x)
            if not (torch.isfinite(b).all() and torch.equal(a, b)):
                err = (a.float() - b.float()).abs().max().item()
                raise AssertionError(f"reference_bitlinear {name} M={M}: "
                                     f"max abs err {err} > 0")
    emit({"phase": "reference_bitlinear", "layer": 0,
          "projections": list(gpu.layers[0].projs), "M": [4, 512],
          "max_abs_err": 0.0, "tol": 0.0})


def _reference_input(torch, cfg, seed: int = 4, S: int = 512):
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    return (torch.randn((1, S, cfg.hidden_size), generator=gen) * 0.5).half()


def _run_steps(torch, cfg, model, x, dev: str, steps: int = 4):
    """Prefill x [1, S, hidden] on `dev`, then `steps` teacher-forced
    decode steps (x's first rows again): the prefill hidden states [S,
    hidden] and [the last prefill position, each step] in float32 on the
    CPU."""
    S = x.shape[1]
    pos = torch.arange(S)[None]
    hid, ks, vs = model.make_prefill(S)(x.to(dev), pos.to(dev))
    shape = (cfg.num_layers, 1, S + steps, cfg.num_kv_heads, cfg.head_dim)
    ck = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    cv = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    ck[:, 0, :S] = torch.stack(ks).to(torch.bfloat16)
    cv[:, 0, :S] = torch.stack(vs).to(torch.bfloat16)
    hs = [hid[0, -1].float().cpu()]
    slots = torch.zeros((1,), dtype=torch.int32, device=dev)
    for i in range(steps):
        lengths = torch.tensor([S + i], dtype=torch.int32, device=dev)
        h, ck, cv = model.decode_step(x[:, i:i + 1].to(dev), ck, cv, slots,
                                      lengths)
        hs.append(h[0, 0].float().cpu())
    return hid[0].float().cpu(), torch.stack(hs)


def _gap(a, b) -> dict:
    """a against b (b the CPU's): max abs error, its ratio to max |b|,
    and the rms error over the rms of b."""
    d = a - b
    err = d.abs().max().item()
    return {"max_abs_err": err, "max_rel_err": err / b.abs().max().item(),
            "rms_rel_err": (d.square().mean() / b.square().mean())
            .sqrt().item()}


def _bitnet_logits(torch, cfg, model, x, dev: str, head):
    """{prefill: logits of the last 64 prefill positions, decode: of the
    last prefill position and each decode step}, through the CPU head."""
    pre, dec = _run_steps(torch, cfg, model, x, dev)
    return {"prefill": head.logits(pre[-64:]), "decode": head.logits(dec)}


def _decided(lc, lp, tol: float):
    """Rows of lp (the CPU's logits) whose top-2 margin exceeds tol, and
    each row's margin; the card's greedy token (of lc) must be the CPU's
    on every such row."""
    top = lp.topk(2, dim=-1).values
    margin = top[:, 0] - top[:, 1]
    decided = margin > tol
    if (decided & (lc.argmax(-1) != lp.argmax(-1))).any():
        raise AssertionError(f"greedy tokens differ where the CPU's margin "
                             f"exceeds {tol}")
    return int(decided.sum()), margin


def reference_steps(torch, cfg, gpu, cpu, phase: str, heads=None,
                    hidden_tol: float = 2e-2):
    """Prefill a 512-token input on the card and on the CPU, then 4
    teacher-forced decode steps. Without `heads`, hidden states agree
    within `hidden_tol` of the largest (2e-2 for f16 activations through
    2 layers: a few
    f16 ulps of the largest value per op, summed). With the LM `heads`
    (BitNet), the logits of the last 64 prefill positions and of every
    decode step agree within BITNET_LOGIT_RMS (rms) and BITNET_LOGIT_MAX
    (max) of the largest, and the greedy tokens on every row the CPU
    decides, of which there must be BITNET_MIN_DECIDED[0]."""
    from bitblas_tpu_torch.models.quant_llama import layer_forward
    x = _reference_input(torch, cfg)
    errs = {}
    if heads is None:
        rel_tol = hidden_tol
        outs = {dev: _run_steps(torch, cfg, model, x, dev)
                for dev, model in (("cuda", gpu), ("cpu", cpu))}
        for i, key in enumerate(("prefill_hidden", "decode_hidden")):
            a, b = outs["cuda"][i], outs["cpu"][i]
            if not torch.isfinite(a).all():
                raise AssertionError(f"{phase}: non-finite {key} on the card")
            errs[key] = _gap(a, b)
            if errs[key]["max_rel_err"] > rel_tol:
                raise AssertionError(f"{phase} {key}: {errs[key]} > "
                                     f"{rel_tol}")
    else:
        rel_tol = BITNET_LOGIT_MAX
        head = heads["cpu"]
        card = _bitnet_logits(torch, cfg, gpu, x, "cuda", head)
        ref = _bitnet_logits(torch, cfg, cpu, x, "cpu", head)
        decided = 0
        for key in ("prefill", "decode"):
            a, b = card[key], ref[key]
            if not torch.isfinite(a).all():
                raise AssertionError(f"{phase}: non-finite {key} logits on "
                                     f"the card")
            gap = errs[key + "_logits"] = _gap(a, b)
            if (gap["max_rel_err"] > rel_tol
                    or gap["rms_rel_err"] > BITNET_LOGIT_RMS):
                raise AssertionError(f"{phase} {key} logits: {gap} > "
                                     f"{rel_tol} (max), {BITNET_LOGIT_RMS} "
                                     f"(rms)")
            n, _ = _decided(a, b, rel_tol * b.abs().max().item())
            decided += n
        if decided < BITNET_MIN_DECIDED[0]:
            raise AssertionError(f"{phase}: {decided} decided tokens < "
                                 f"{BITNET_MIN_DECIDED[0]}")
        errs["tokens_decided"] = decided
        twin = x
        for layer in cpu.layers:   # plain masked softmax, no flash
            twin = layer_forward(layer, twin, torch.arange(x.shape[1])[None])
        errs["cpu_floor_prefill_logits"] = _gap(
            head.logits(twin[0, -64:].float()), ref["prefill"])
    emit({"phase": phase, "layers": cfg.num_layers, "prompt": x.shape[1],
          "decode_steps": 4, "rel_tol": rel_tol,
          **({"rms_rel_tol": BITNET_LOGIT_RMS} if heads else {}), **errs})


def bitnet_readings(torch, cfg=None, seeds=(21, 22, 23, 24, 25),
                    inputs=None) -> None:
    """The readings the BitNet limits are set from, one line per seed and
    input (the model's weights; `cfg` 2 layers at Llama-3-8B widths by
    default; `inputs` (input seed, S) pairs, by default the weights' seed
    at S = 512): the card against the CPU, the CPU against itself with the
    plain masked softmax, and two glue faults on the CPU against the CPU
    -- activations rounded to bfloat16 before their int8 quantization,
    and each BitLinear's output rounded to bfloat16 -- each as max and rms
    error relative to the CPU's logits and hidden states (the prefill's
    after the first layer too: `layer1_hidden`); the CPU's top-2 margins
    relative to its largest logit (teacher-forced rows, and the token
    engine's steps up to each request's first split, at the first
    input)."""
    import contextlib

    from bitblas_tpu_torch.models import bitnet as bn
    from bitblas_tpu_torch.models.quant_llama import layer_forward

    @contextlib.contextmanager
    def patched(obj, name, value):
        old = getattr(obj, name)
        setattr(obj, name, value)
        try:
            yield
        finally:
            setattr(obj, name, old)

    quant, forward = bn.activation_quant_int8, bn.BitLinearInference.forward
    controls = {
        "bf16_activations": (bn, "activation_quant_int8",
                             lambda x: quant(x.to(torch.bfloat16))),
        "bf16_outputs": (bn.BitLinearInference, "forward",
                         lambda self, x: forward(self, x)
                         .to(torch.bfloat16).to(x.dtype)),
    }
    cfg = cfg or bitnet_llama3_8b(2)
    heads = _reference_heads(torch, cfg)
    head = heads["cpu"]

    def hidden_and_logits(model, x, dev):
        pre, dec = _run_steps(torch, cfg, model, x, dev)
        return ({"prefill": pre, "decode": dec,
                 "layer1": _layer1_hidden(torch, model, x, dev)},
                {"prefill": head.logits(pre[-64:]),
                 "decode": head.logits(dec)})

    for seed in seeds:
        gpu, cpu = _card_and_cpu(
            torch, lambda **kw: bn.BitNetLlama(cfg, **kw), seed=seed)
        for i, (input_seed, S) in enumerate(inputs or ((seed, 512),)):
            t0 = time.perf_counter()
            x = _reference_input(torch, cfg, seed=input_seed, S=S)
            ref_h, ref = hidden_and_logits(cpu, x, "cpu")
            runs = {"card": hidden_and_logits(gpu, x, "cuda")}
            for name, (obj, attr, value) in controls.items():
                with patched(obj, attr, value):
                    runs[name] = hidden_and_logits(cpu, x, "cpu")
            row = {"phase": "bitnet_readings", "seed": seed,
                   "input_seed": input_seed, "prompt": S,
                   "hidden": cfg.hidden_size, "head_dim": cfg.head_dim}
            for name, (hid, logits) in runs.items():
                row[name] = {**{k: _gap(logits[k], ref[k]) for k in ref},
                             **{f"{k}_hidden": _gap(hid[k], ref_h[k])
                                for k in ref_h}}
            pos = torch.arange(S)[None]
            twin = layer_forward(cpu.layers[0], x, pos)
            layer1 = twin[0].float()
            for layer in cpu.layers[1:]:
                twin = layer_forward(layer, twin, pos)
            row["cpu_floor"] = {"prefill": _gap(
                head.logits(twin[0, -64:].float()), ref["prefill"]),
                "prefill_hidden": _gap(twin[0].float(), ref_h["prefill"]),
                "layer1_hidden": _gap(layer1, ref_h["layer1"])}
            margins = torch.cat([
                _decided(ref[k], ref[k], float("inf"))[1] / ref[k].abs().max()
                for k in ref])
            row["margins_rel"] = sorted(round(m, 5) for m in margins.tolist())
            if i == 0:
                eng = compare_engines(torch, cfg, gpu, cpu, tag="_bitnet",
                                      heads=heads, rel_tol=1.0)
                row["engine"] = {
                    "max_logit_rel_err": eng["max_logit_rel_err"],
                    "margins_rel": eng["margins_rel"]}
            row["seconds"] = time.perf_counter() - t0
            emit(row)
        del gpu, cpu
        torch.cuda.empty_cache()


def _layer1_hidden(torch, model, x, dev: str):
    """The prefill's hidden states [S, hidden] after the model's first
    layer alone, in float32 on the CPU."""
    layers = model.layers
    model.layers = layers[:1]
    try:
        S = x.shape[1]
        hid, _, _ = model.make_prefill(S)(x.to(dev),
                                          torch.arange(S)[None].to(dev))
    finally:
        model.layers = layers
    return hid[0].float().cpu()


def _reference_heads(torch, cfg):
    """An LMHead on the card and one on the CPU with the same seeded
    weights (the model's vocab)."""
    from bitblas_tpu_torch.models.hf_import import LMHead
    gen = torch.Generator(device="cpu")
    gen.manual_seed(6)
    V, Hd = cfg.vocab_size, cfg.hidden_size
    embed = (torch.randn((V, Hd), generator=gen) * 0.05).half()
    lm_head = torch.randn((V, Hd), generator=gen) * 0.05
    return {dev: LMHead(embed, torch.ones(Hd), lm_head,
                        norm_eps=cfg.rms_norm_eps, device=dev)
            for dev in ("cuda", "cpu")}


def compare_engines(torch, cfg, gpu, cpu, kv_quant: bool = False,
                    tag: str = "", heads=None, rel_tol: float = 2e-2,
                    min_decided: int = 0, lengths=(200, 300, 450, 500),
                    budgets=(4, 8, 6, 8), max_seq_len: int = 1024,
                    engine_kw=None):
    """TokenContinuousBatchingEngine with four live slots, on the card and
    on the CPU with the same weights: prompts in buckets 256 and 512, and
    budgets that release slots while others still decode. Each request's
    logits agree step by step (within `rel_tol` of the largest) while its
    greedy tokens agree; tokens may part only where the card's pick is
    within that tolerance of the CPU's best logit, and with every token
    equal the final hidden states agree too. A step is decided where the
    CPU's top-2 margin exceeds the tolerance (the tokens are then equal):
    at least `min_decided` of them. Catches a mix-up of slots or lengths
    in the engine or the decode path that one sequence cannot. Returns
    the emitted row and the CPU's top-2 margins relative to each step's
    largest logit."""
    import numpy as np
    from bitblas_tpu_torch.serving.engine import TokenContinuousBatchingEngine

    heads = heads or _reference_heads(torch, cfg)
    V = cfg.vocab_size
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, V, n).astype(np.int32) for n in lengths]
    runs = {}
    for dev, model in (("cuda", gpu), ("cpu", cpu)):
        head = heads[dev]
        eng = TokenContinuousBatchingEngine(model, head, num_slots=4,
                                            max_seq_len=max_seq_len,
                                            kv_quant=kv_quant,
                                            **(engine_kw or {}))
        rows = {}
        sample = eng._sample

        def recording_sample(req, logits_row, rows=rows, sample=sample):
            rows.setdefault(req.uid, []).append(logits_row.copy())
            return sample(req, logits_row)

        eng._sample = recording_sample
        reqs = [eng.submit_tokens(uid=i, tokens=p, max_new=n)
                for i, (p, n) in enumerate(zip(prompts, budgets))]
        eng.run_to_completion()
        if not all(r.done and len(r.out_tokens) == r.max_new for r in reqs):
            raise AssertionError(f"reference engine on {dev}: a request "
                                 f"did not finish")
        runs[dev] = (reqs, rows)
    logit_err, rel_err, hidden_err, same = 0.0, 0.0, 0.0, []
    decided, margins = 0, []
    for rc, rp in zip(*(runs[d][0] for d in ("cuda", "cpu"))):
        lc, lp = runs["cuda"][1][rc.uid], runs["cpu"][1][rp.uid]
        for i, (tc, tp) in enumerate(zip(rc.out_tokens, rp.out_tokens)):
            if not np.isfinite(lc[i]).all():
                raise AssertionError(f"reference engine: non-finite logits "
                                     f"on the card, request {rc.uid}")
            err = float(np.abs(lc[i] - lp[i]).max())
            # the logits inherit the hidden states' few f16 ulps
            scale = float(np.abs(lp[i]).max())
            tol = rel_tol * scale
            if err > tol:
                raise AssertionError(f"reference engine{tag}: request "
                                     f"{rc.uid} step {i} logits {err} > "
                                     f"{tol}")
            logit_err = max(logit_err, err)
            rel_err = max(rel_err, err / scale)
            top2 = np.partition(lp[i], -2)[-2:]
            margins.append(float(top2[1] - top2[0]) / scale)
            decided += bool(top2[1] - top2[0] > tol)
            if tc != tp:   # the next steps feed different tokens
                # the card's pick must be within tol of the CPU's best
                if lp[i][tp] - lp[i][tc] > tol:
                    raise AssertionError(
                        f"reference engine{tag}: request {rc.uid} step {i} "
                        f"token {tc} vs {tp}, no tie within {tol}")
                break
        same.append(rc.out_tokens == rp.out_tokens)
        if same[-1]:
            err = float(np.abs(rc.final_hidden - rp.final_hidden).max())
            scale = float(np.abs(rp.final_hidden).max())
            if err > rel_tol * scale:
                raise AssertionError(f"reference engine{tag}: request "
                                     f"{rc.uid} final hidden {err} > "
                                     f"{rel_tol} * {scale}")
            hidden_err = max(hidden_err, err)
    row = {"phase": "reference_engine" + ("_kv_quant" if kv_quant else "")
           + tag,
           "layers": cfg.num_layers, "num_slots": 4, **(engine_kw or {}),
           "prompts": [len(p) for p in prompts], "max_new": list(budgets),
           "rel_tol": rel_tol, "tokens_equal": same,
           "tokens_decided": decided, "max_logit_abs_err": logit_err,
           "max_logit_rel_err": rel_err,
           "final_hidden_max_abs_err": hidden_err}
    emit(row)
    if decided < min_decided:
        raise AssertionError(f"reference engine{tag}: {decided} decided "
                             f"tokens < {min_decided}")
    return {**row, "margins_rel": sorted(round(m, 5) for m in margins)}


def compare_paged(torch, cfg, gpu, cpu, kv_quant: bool,
                  rel_tol: float = 2e-2, tag: str = ""):
    """PagedContinuousBatchingEngine (block size 16, four slots) on the
    card and on the CPU with the same weights: embedded prompts of 200 and
    300 tokens and two that share a 256-token prefix, budgets that release
    slots at different steps. After every step the block tables and prefix
    hits are identical, and each live request's hidden state gives logits
    within `rel_tol` x max |logit| of the CPU's (2e-2 for f16
    activations); its greedy token (argmax) is reported per request."""
    import numpy as np
    from bitblas_tpu_torch.serving.engine import (
        PagedContinuousBatchingEngine, Request)

    heads = _reference_heads(torch, cfg)
    V = cfg.vocab_size
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, V, 256)
    prompts = [rng.integers(0, V, n) for n in (200, 300)] + [
        np.concatenate([prefix, rng.integers(0, V, n)]) for n in (40, 90)]
    budgets = (4, 8, 6, 8)
    runs = {}
    for dev, model in (("cuda", gpu), ("cpu", cpu)):
        head = heads[dev]
        eng = PagedContinuousBatchingEngine(
            model, num_slots=4, num_blocks=1 + 4 * 64, block_size=16,
            max_blocks_per_slot=64, kv_quant=kv_quant)
        reqs = [Request(uid=i, prompt=head.embed_tokens(p), max_new=n)
                for i, (p, n) in enumerate(zip(prompts, budgets))]
        for r in reqs:
            eng.submit(r)
        tables, logits = [], {}
        while eng.active or eng.pending:
            eng.step()
            tables.append(eng.tables.copy())
            rows = head.logits(eng.last_hidden.float()).cpu().numpy()
            for slot, r in eng.active.items():
                logits.setdefault(r.uid, []).append(rows[slot])
        for r in reqs:
            if not (r.done and np.isfinite(r.final_hidden).all()):
                raise AssertionError(f"reference paged on {dev}: request "
                                     f"{r.uid} did not finish cleanly")
            logits.setdefault(r.uid, []).append(head.logits(torch.tensor(
                r.final_hidden, device=head.embed.device)[None])
                .cpu().numpy()[0])
        runs[dev] = (tables, logits, eng.prefix_hits)
    (tc, lc, hc), (tp, lp, hp) = runs["cuda"], runs["cpu"]
    if len(tc) != len(tp) or not all(np.array_equal(a, b)
                                     for a, b in zip(tc, tp)):
        raise AssertionError("reference paged: block tables differ")
    if hc != hp or hc <= 0:
        raise AssertionError(f"reference paged: prefix hits {hc} vs {hp}")
    logit_err, same = 0.0, []
    for uid in sorted(lp):
        if len(lc[uid]) != len(lp[uid]):
            raise AssertionError(f"reference paged: request {uid} steps")
        for a, b in zip(lc[uid], lp[uid]):
            if not np.isfinite(a).all():
                raise AssertionError("reference paged: non-finite logits")
            err = float(np.abs(a - b).max())
            if err > rel_tol * float(np.abs(b).max()):
                raise AssertionError(f"reference paged: request {uid} "
                                     f"logits {err}")
            logit_err = max(logit_err, err)
        same.append([int(a.argmax()) for a in lc[uid]]
                    == [int(b.argmax()) for b in lp[uid]])
    emit({"phase": "reference_paged" + ("_quant" if kv_quant else "") + tag,
          "layers": cfg.num_layers, "num_slots": 4, "block_size": 16,
          "rel_tol": rel_tol,
          "prompts": [len(p) for p in prompts], "max_new": list(budgets),
          "steps": len(tc), "prefix_hits": hc, "tables_equal": True,
          "tokens_equal": same, "max_logit_abs_err": logit_err})


def serving_model(torch, family: str = "llama"):
    """The 32-layer model on the card (W4A16 Llama-2-7B or W2A8 BitNet at
    Llama-3-8B widths), its LMHead, the four token prompts of every serve
    phase and the pair that shares a 256-token prefix."""
    import numpy as np
    from bitblas_tpu_torch.models.bitnet import BitNetLlama
    from bitblas_tpu_torch.models.hf_import import LMHead
    from bitblas_tpu_torch.models.quant_llama import QuantLlama

    t0 = time.perf_counter()
    if family == "bitnet":
        cfg = bitnet_llama3_8b(32)
        # the tuned buckets: each projection's Matmul comes from the
        # global operator cache, one per (N, K)
        model = BitNetLlama(cfg, opt_m=BITNET_BUCKETS, device="cuda",
                            seed=0)
        name = "BitNet b1.58 W2A8, Llama-3-8B widths"
    else:
        cfg = llama2_7b(32)
        model = QuantLlama(cfg, device="cuda", seed=0)
        name = "Llama-2-7B widths, W4A16 g128"
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    V, Hd = cfg.vocab_size, cfg.hidden_size
    head = LMHead(
        embed=(torch.randn((V, Hd), generator=gen, device="cuda") * 0.05
               ).half(),
        final_norm=torch.ones(Hd, device="cuda"),
        lm_head=torch.randn((V, Hd), generator=gen, device="cuda") * 0.05,
        norm_eps=cfg.rms_norm_eps, device="cuda")
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, n).astype(np.int32)
               for n in (200, 300, 450, 500)]
    prefix = rng.integers(0, V, 256)
    pair = [np.concatenate([prefix, rng.integers(0, V, n)]).astype(np.int32)
            for n in (40, 90)]
    packed = sum(t.numel() * t.element_size()
                 for n, t in model.named_buffers() if "qweight" in n or
                 "scales" in n or "zeros" in n or n.endswith(".sw"))
    return {"cfg": cfg, "model": model, "head": head, "prompts": prompts,
            "pair": pair, "init_s": time.perf_counter() - t0, "name": name,
            "weight_bytes": packed}


# the launch counts of kernel 1's split-K decode instances and of its
# wgmma + TMA tiled instances (GPTQ's, BitNet's and the bfloat16 uint4
# model's formats), beside the kernels' own counts
# (dequant_matmul_{u4,i2,fmt}.decode_launches, .tiled_launches)
BF16_U4 = "uint4xbfloat16"
DECODE = {"uint4": "dequant_matmul_u4_decode",
          "int2": "dequant_matmul_i2_decode",
          BF16_U4: "dequant_matmul_fmt_decode"}
TILED = {"uint4": "dequant_matmul_u4_tiled", "int2": "dequant_matmul_i2_tiled",
         BF16_U4: "dequant_matmul_fmt_tiled"}
# each format's fused wrapper and its materialize plan's weight decoder
FUSED = {"uint4": "dequant_matmul_u4", "int2": "dequant_matmul_i2",
         BF16_U4: "dequant_matmul_fmt"}
MATERIALIZE = {"uint4": "weight_decode_u4", "int2": "weight_decode_int8",
               BF16_U4: "weight_decode_fmt"}
# phase -> (engine, engine options, the kernels its path must launch)
LLAMA = ("dequant_matmul_u4", DECODE["uint4"], TILED["uint4"],
         "weight_decode_u4", "flash_attention_fwd")
SERVE_PHASES = (
    ("serve", "token", {}, LLAMA + ("flash_decode",)),
    ("serve_kv_quant", "token", {"kv_quant": True},
     LLAMA + ("flash_decode_quant",)),
    ("serve_paged", "paged", {}, LLAMA + ("flash_decode_paged",)),
    ("serve_paged_quant", "paged", {"kv_quant": True},
     LLAMA + ("flash_decode_paged_quant",)),
)
# the imported GPTQ model (group 64): the fused kernel's g64 instances and
# kernel 2 at g64 must launch
GPTQ_PHASE = ("serve_gptq", "token", {},
              LLAMA + ("flash_decode", "dequant_matmul_u4 decode g64",
                       "dequant_matmul_u4 tiled g64", "weight_decode_u4 g64"))
BITNET_PHASE = ("serve_bitnet", "token", {},
                ("dequant_matmul_i2", DECODE["int2"], TILED["int2"],
                 "weight_decode_int8", "flash_attention_fwd", "flash_decode"))
# serve_bitnet_tuned's GEMM kernels are the routes the database chose
# (checked against the recorded routes); the attention kernels are fixed
BITNET_TUNED_PHASE = ("serve_bitnet_tuned", "token", {},
                      ("flash_attention_fwd", "flash_decode"))
MAX_NEW = 32

MISTRAL_GEMMS = ("dequant_matmul_fmt", DECODE[BF16_U4], "weight_decode_fmt")
MISTRAL_PHASES = (
    ("serve_mistral", "token", {},
     MISTRAL_GEMMS + ("flash_attention_fwd bfloat16 window",
                      "flash_decode bfloat16 window")),
    ("serve_mistral_kv_quant", "token", {"kv_quant": True},
     MISTRAL_GEMMS + ("flash_attention_fwd bfloat16 window",
                      "flash_decode_quant bfloat16 window")),
    # chunks of 256 take the tiled instance; the attends are torch ops
    ("serve_mistral_ring", "token",
     {"prefill_chunk": MISTRAL_CHUNK, "kv_ring": True},
     ("dequant_matmul_fmt", DECODE[BF16_U4], TILED[BF16_U4],
      "ring_attends")),
)


# The ring cache's attends (plain PyTorch, as JAX's are XLA), each counting
# its calls in serving.kv_cache.
RING_ATTENDS = ("ring_decode_attention", "ring_decode_attention_quant",
                "ring_chunk_attention", "ring_chunk_attention_quant")


class RouteRecorder:
    """Counts the plan each Matmul.forward call takes (the hint of its M),
    by weight format, while installed, so a serve phase can check that
    the GEMM kernels launched exactly as the operators' hints route: one
    fused-kernel launch per "fused" call, one weight decode per
    "materialize" call, one launch of kernel 1's split-K decode instance
    per fused call whose hint names it and one of a wgmma + TMA tiled
    instance per fused call whose hint names one; on untuned operators
    those are the fused calls with M <= 16 and M > 16."""

    def __init__(self):
        from bitblas_tpu_torch.ops.matmul import Matmul
        self.cls, self.orig = Matmul, Matmul.forward
        self.calls = {}
        self.by_hint = {}
        self.shapes = {}

    def __enter__(self):
        from bitblas_tpu_torch.kernels.dequant_matmul import (FUSED_TILES,
                                                              is_tiled,
                                                              spec_format)
        orig, calls, by_hint = self.orig, self.calls, self.by_hint
        shapes = self.shapes

        def recording(op, A, W, *args, **kw):
            m = A.numel() // A.shape[-1]
            hint = op.hint_for(m)
            fmt = spec_format(op._spec)
            keys = [f"{fmt} {hint.decode_mode}"]
            kind = hint.decode_mode
            if hint.decode_mode == "fused":
                if is_tiled(fmt, hint.tile):
                    keys.append(f"{fmt} tiled")
                    kind = "tiled"
                elif tuple(hint.tile) == FUSED_TILES[fmt][0]:
                    keys.append(f"{fmt} decode")
                    kind = "decode"
                keys.append(f"{fmt} fused M{'>' if m > 16 else '<='}16")
            for key in keys:
                calls[key] = calls.get(key, 0) + 1
            # the calls by plan and (N, K): "uint4 decode 14336x4096", ...
            key = f"{fmt} {kind} {op.config.N}x{op.config.K}"
            shapes[key] = shapes.get(key, 0) + 1
            by_hint[hint.short_name()] = by_hint.get(hint.short_name(),
                                                     0) + 1
            return orig(op, A, W, *args, **kw)

        self.cls.forward = recording
        return self

    def __exit__(self, *exc):
        self.cls.forward = self.orig

    def reset(self):
        self.calls.clear()
        self.by_hint.clear()
        self.shapes.clear()

    def check(self, phase, launches, untuned: bool):
        c = self.calls
        want = {**{name: c.get(f"{fmt} fused", 0)
                   for fmt, name in FUSED.items()},
                **{name: c.get(f"{fmt} materialize", 0)
                   for fmt, name in MATERIALIZE.items()},
                **{name: c.get(f"{fmt} decode", 0)
                   for fmt, name in DECODE.items()},
                **{name: c.get(f"{fmt} tiled", 0)
                   for fmt, name in TILED.items()}}
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"{phase}: GEMM launches {got} differ from "
                                 f"the routes of the hints {self.calls}")
        if untuned and any(
                launches[DECODE[fmt]] != c.get(f"{fmt} fused M<=16", 0)
                or launches[TILED[fmt]] != c.get(f"{fmt} fused M>16", 0)
                for fmt in TILED):
            raise AssertionError(f"{phase}: decode / tiled launches {got} "
                                 f"differ from the fused calls with M <= 16 "
                                 f"/ M > 16 {self.calls}")
        return {"routes": dict(self.calls), "hints": dict(self.by_hint),
                "shapes": dict(self.shapes)}


def serve(torch, ctx, counters, phase, kind, kw, expect, routes=None,
          profile: bool = True):
    """One serve phase: every launch counter reset to 0, the requests
    submitted and the engine stepped to the end (a sync after each step so
    each step's wall time is its own), the counters read. Steps that
    admitted nothing give the decode metrics; steps that admitted requests
    give prefill tokens/s (their time less one mean decode step). With a
    RouteRecorder `routes`, the GEMM launches must match the routes its
    Matmul calls took. `profile`: a token phase's decode profile after the
    timed run (profile_decode)."""
    import numpy as np
    from bitblas_tpu_torch.serving.engine import (
        PagedContinuousBatchingEngine, Request,
        TokenContinuousBatchingEngine, TokenRequest)

    model, head = ctx["model"], ctx["head"]
    if kind == "token":
        eng = TokenContinuousBatchingEngine(
            model, head, num_slots=4,
            max_seq_len=ctx.get("max_seq_len", 1024), **kw)

        def submit():
            return [eng.submit_tokens(uid=i, tokens=p, max_new=MAX_NEW)
                    for i, p in enumerate(ctx["prompts"])]
    else:
        eng = PagedContinuousBatchingEngine(
            model, num_slots=4, num_blocks=1 + 4 * 64, block_size=16,
            max_blocks_per_slot=64, **kw)

        def submit():
            reqs = [Request(uid=i, prompt=head.embed_tokens(p),
                            max_new=MAX_NEW)
                    for i, p in enumerate(ctx["prompts"] + ctx["pair"])]
            for r in reqs:
                eng.submit(r)
            return reqs
    kv_bytes = sum(t.numel() * t.element_size() for t in (
        eng.caches_k, eng.caches_v, *((eng.scales_k, eng.scales_v)
                                      if kw.get("kv_quant") else ())))

    torch.cuda.synchronize()
    by_name = {c.__name__: c for c in counters}
    split = {fmt: by_name[name] for fmt, name in FUSED.items()}
    for c in counters:
        c.launches = 0
        if hasattr(c, "variant_launches"):
            c.variant_launches.clear()
    for c in split.values():
        c.decode_launches = c.tiled_launches = 0
    if routes is not None:
        routes.reset()
    from bitblas_tpu_torch.serving import kv_cache
    rings = [getattr(kv_cache, n) for n in RING_ATTENDS]
    for fn in rings:
        fn.calls = 0
    from bitblas_tpu_torch.models.quant_llama import DecoderServingMixin
    DecoderServingMixin.plain_prefills = 0
    if "reset" in ctx:      # the context's own counters (its "stats")
        ctx["reset"]()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reqs = submit()
    steps = []          # (seconds, prompt tokens admitted, tokens decoded)
    while eng.active or eng.pending:
        waiting = list(eng.pending)
        made = sum(r.generated for r in reqs)
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - ts
        admitted = [r for r in waiting if r not in eng.pending]
        first = sum(isinstance(r, TokenRequest) for r in admitted)
        steps.append((dt, sum(len(r.prompt) for r in admitted),
                      sum(r.generated for r in reqs) - made - first))
    wall = time.perf_counter() - t0
    model_stats = ctx["stats"]() if "stats" in ctx else {}
    launches = {c.__name__: c.launches for c in counters}
    for fmt, wrapper in split.items():
        launches[DECODE[fmt]] = wrapper.decode_launches
        launches[TILED[fmt]] = wrapper.tiled_launches
    # kernels 1 and 2 by group size, zeros mode and bias ("dequant_matmul_u4
    # decode g128", "weight_decode_u4 g64", ...), the attention kernels by
    # query type and window ("flash_decode bfloat16 window", ...)
    for c in counters:
        for variant, n in getattr(c, "variant_launches", {}).items():
            launches[f"{c.__name__} {variant}"] = n
    if kw.get("kv_ring"):
        launches["ring_attends"] = sum(fn.calls for fn in rings)
    peak = torch.cuda.max_memory_allocated()

    if not all(r.done and r.generated == MAX_NEW for r in reqs):
        raise AssertionError(f"{phase}: a request did not finish")
    if not all(np.isfinite(r.final_hidden).all() for r in reqs):
        raise AssertionError(f"{phase}: non-finite hidden state")
    final_logits = head.logits(torch.tensor(
        np.stack([r.final_hidden for r in reqs]), device=head.embed.device))
    if not torch.isfinite(final_logits).all():
        raise AssertionError(f"{phase}: non-finite logits at completion")
    if min(launches.get(k, 0) for k in expect) <= 0:
        raise AssertionError(f"{phase}: a kernel was not launched: "
                             f"{launches}")
    if DecoderServingMixin.plain_prefills:
        raise AssertionError(
            f"{phase}: {DecoderServingMixin.plain_prefills} prefills that "
            f"JAX's rule runs through kernel 4 took the plain masked "
            f"softmax (a shape the kernel refuses)")
    if kw.get("kv_ring") and eng.caches_k.shape[2] != ctx.get(
            "ring_rows", eng.caches_k.shape[2]):
        raise AssertionError(f"{phase}: ring of {eng.caches_k.shape[2]} "
                             f"rows, expected {ctx['ring_rows']}")
    if kw.get("kv_ring") and any(launches[k] for k in (
            "flash_attention_fwd", "flash_decode", "flash_decode_quant")):
        raise AssertionError(f"{phase}: the ring's attends are torch ops, "
                             f"but an attention kernel launched: {launches}")
    route_row = (routes.check(phase, launches,
                              untuned=phase != BITNET_TUNED_PHASE[0])
                 if routes is not None else {})
    pure = [(dt, n) for dt, adm, n in steps if adm == 0]
    step_s = sum(dt for dt, _ in pure) / max(len(pure), 1)
    adm = [(dt, a) for dt, a, _ in steps if a > 0]
    row = {"phase": phase, "model": ctx["name"],
           "layers": ctx["cfg"].num_layers, "num_slots": 4,
           "engine": type(eng).__name__, **kw,
           "max_seq_len": ctx.get("max_seq_len", 1024),
           "cache_rows": eng.caches_k.shape[2],
           "prompts": [len(r.prompt) for r in reqs], "max_new": MAX_NEW,
           "init_s": ctx["init_s"], "first_step_s": steps[0][0],
           "steps": len(steps), "decode_steps": len(pure),
           "decode_step_ms": step_s * 1e3,
           "decode_tok_s": sum(n for _, n in pure)
           / max(sum(dt for dt, _ in pure), 1e-9),
           "prefill_tok_s": sum(a for _, a in adm)
           / max(sum(dt - step_s for dt, _ in adm), 1e-9),
           "wall_s": wall, "launches": launches, **route_row,
           "plain_prefills": DecoderServingMixin.plain_prefills,
           "peak_mem_gb": peak / 2 ** 30, "kv_bytes": kv_bytes,
           "weight_bytes": ctx["weight_bytes"], **model_stats}
    if kind == "token":
        row["sample_tokens"] = reqs[0].out_tokens[:8]
        row["tokens_sha1"] = _tokens_sha(reqs)
    else:
        row["prefix_hits"] = eng.prefix_hits
        if eng.prefix_hits <= 0:
            raise AssertionError(f"{phase}: no prefix hit")
    emit(row)
    if kind == "token" and profile:
        profile_decode(torch, eng, ctx["prompts"], phase, {
            "serve_kernel4_variant_launches": {
                k.split(" ", 1)[1]: n for k, n in launches.items()
                if k.startswith("flash_attention_fwd ")}})
    del eng
    torch.cuda.empty_cache()
    return row


# The tune phase: the distinct Matmul configurations of the two serving
# models at full width, with their M buckets.
LLAMA_SHAPES = ((4096, 4096), (11008, 4096), (4096, 11008))   # (N, K)
LLAMA_BUCKETS = (1, 16, 256)
BITNET_SHAPES_ALL = ((4096, 4096), (1024, 4096), (14336, 4096),
                     (4096, 14336))
BITNET_BUCKETS = (1, 16, 32, 64, 128, 256)
W4A16 = dict(A_dtype="float16", W_dtype="uint4", with_scaling=True,
             with_zeros=True, zeros_mode="original", group_size=128,
             out_dtype="float16")
W2A8 = dict(A_dtype="int8", W_dtype="int2", accum_dtype="int32",
            out_dtype="float32")


def tune(torch, db_dir: str):
    """Tune every configuration through the global operator cache
    (Matmul with enable_tuning=True measures each bucket's candidates
    with CUDA events and installs the winner), print each bucket's winner
    beside the default and the roofline, save the tuned hints into a
    database in `db_dir`, clear the cache and load it back: the hints
    must be equal, and each reloaded operator's forward must equal the
    tuned operator's bit for bit at M = 4 and 256 (and the default
    route's: int2 bit for bit, uint4 within one f16 rounding)."""
    from bitblas_tpu_torch.cache import (global_operator_cache,
                                         load_global_ops_cache)
    from bitblas_tpu_torch.ops.matmul import Matmul
    from bitblas_tpu_torch.ops.matmul_config import MatmulConfig
    from bitblas_tpu_torch.tuner import default_hint, roofline_seconds

    configs = (
        [MatmulConfig(M=list(LLAMA_BUCKETS), N=N, K=K, **W4A16)
         for N, K in LLAMA_SHAPES]
        + [MatmulConfig(M=list(BITNET_BUCKETS), N=N, K=K, **W2A8)
           for N, K in BITNET_SHAPES_ALL])
    global_operator_cache.clear()
    t0 = time.perf_counter()
    rows = []
    for cfg in configs:
        op = Matmul(cfg, device="cuda", enable_tuning=True)
        global_operator_cache.add(cfg, op)
        for m, res in sorted(op.tune_results.items()):
            spec = op._make_spec(m)
            dflt = default_hint(spec, op.arch)
            times = {h: (t, sp) for h, t, sp in res.candidates}
            row = {"phase": "tune", "format": cfg.W_dtype, "N": cfg.N,
                   "K": cfg.K, "M": m, "winner": res.hint.short_name(),
                   "winner_ms": res.latency * 1e3,
                   "winner_spread": times[res.hint][1],
                   "default": dflt.short_name(),
                   "default_ms": times[dflt][0] * 1e3,
                   "roofline_ms": roofline_seconds(spec, res.hint,
                                                   op.arch) * 1e3,
                   "candidates_ms": {h.short_name(): t * 1e3
                                     for h, (t, _) in times.items()}}
            emit(row)
            rows.append(row)
    tune_s = time.perf_counter() - t0
    hints = {cfg: global_operator_cache.get(cfg).hints for cfg in configs}
    tuned_out = {}
    for cfg in configs:
        op = global_operator_cache.get(cfg)
        W = op._example_weights()
        for m in (4, 256):
            tuned_out[cfg, m] = op.forward(op._example_input(m), *W)
        del W
    global_operator_cache.save_into_database(db_dir)
    global_operator_cache.clear()
    loaded = load_global_ops_cache(db_dir)
    if loaded != len(configs):
        raise AssertionError(f"tune: {loaded} of {len(configs)} operators "
                             f"loaded from the database")
    for cfg in configs:
        op = global_operator_cache.get(cfg)
        if op.hints != hints[cfg] or op.tuned_hints:
            raise AssertionError(f"tune: reloaded hints of {cfg} differ")
        default = Matmul(cfg, device="cuda", enable_tuning=False)
        W = op._example_weights()
        for m in (4, 256):
            A = op._example_input(m)
            a, b = op.forward(A, *W), default.forward(A, *W)
            torch.cuda.synchronize()
            # the reloaded route is the tuned one, bit for bit; against
            # the default route int2 is exact and uint4 within one f16
            # rounding of f32 sums (the split-K decode instance sums by
            # split, the tiled instances and cuBLAS along K)
            err = (a.float() - b.float()).abs().max().item()
            tol = 0.0 if cfg.W_dtype == "int2" else \
                4e-3 * b.float().abs().max().item()
            if not (torch.isfinite(a.float()).all()
                    and torch.equal(a, tuned_out[cfg, m]) and err <= tol):
                raise AssertionError(
                    f"tune: {cfg.W_dtype} N={cfg.N} K={cfg.K} M={m}: "
                    f"{op.hint_for(m).short_name()} (reloaded) vs the tuned "
                    f"route and the default "
                    f"{default.hint_for(m).short_name()}: max abs err {err} "
                    f"(tol {tol})")
        del W
    emit({"phase": "tune_summary", "configs": len(configs),
          "buckets": len(rows), "tune_s": tune_s,
          "database_entries": loaded, "hints_equal": True,
          "forward_equal_tuned_at_M": [4, 256],
          "chose_materialize": [f"{r['format']} N={r['N']} K={r['K']} "
                                f"M={r['M']}" for r in rows
                                if r["winner"] == "materialize"]})
    return rows


def bitnet_tuned_ab(torch, counters, rounds: int = 2):
    """serve_bitnet (untuned operators) against serve_bitnet_tuned
    (operators loaded from a database this run tunes), in turns --
    untuned, tuned, tuned, untuned per round -- each on a freshly built
    32-layer model in this one process, to set the difference between
    the two beside the spread of each one's own runs."""
    from bitblas_tpu_torch.cache import (global_operator_cache,
                                         load_global_ops_cache)
    db_dir = tempfile.mkdtemp(prefix="bitblas_tpu_torch_db_")
    rows = {"serve_bitnet": [], "serve_bitnet_tuned": []}
    try:
        tune(torch, db_dir)
        routes = RouteRecorder()
        for tuned in (False, True, True, False) * rounds:
            global_operator_cache.clear()
            if tuned:
                load_global_ops_cache(db_dir)
            phase = BITNET_TUNED_PHASE if tuned else BITNET_PHASE
            with routes:
                ctx = serving_model(torch, "bitnet")
                row = serve(torch, ctx, counters, *phase, routes=routes)
            rows[phase[0]].append(row)
            del ctx
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(db_dir)
    emit({"phase": "bitnet_tuned_ab", "order": "untuned, tuned, tuned, "
          f"untuned x {rounds}", **{
              key: {name: [r[key] for r in rs] for name, rs in rows.items()}
              for key in ("decode_step_ms", "decode_tok_s",
                          "prefill_tok_s")}})


def profile_decode(torch, eng, prompts, phase: str, extra=None,
                   steps: int = 5):
    """Where a decode step's time goes: torch.profiler over a few decode
    steps at 4 active slots, after the timed run (the profiler slows the
    host, so the busy share it reports is a lower bound). `extra` joins
    the row (the serve run's kernel 4 launches by variant)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i, p in enumerate(prompts):
        eng.submit_tokens(uid=100 + i, tokens=p, max_new=steps + 2)
    eng.step()               # admission (prefill) stays out of the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(ev.key, ev.self_device_time_total, ev.count)
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and ev.self_device_time_total > 0]
    device_us = sum(t for _, t, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:6]
    emit({"phase": "profile", "of": phase, "decode_steps": steps,
          "wall_ms_per_step": wall_us / steps / 1e3,
          "device_ms_per_step": device_us / steps / 1e3,
          "device_busy_share": device_us / wall_us if kernels else None,
          "kernel_launches_per_step": sum(c for *_, c in kernels) / steps,
          "top_kernels_ms_per_step": {name[:70]: t / steps / 1e3
                                      for name, t, _ in top},
          **(extra or {})})


# -- kernel 4's configurations (FlashAtten) and BitNet b1.58-3B ------------

# 80: the d80 wgmma instance (H2O-Danube-1.8B's head dim); 160: the
# general instance (a head dim no wgmma instance takes)
FA_DIMS = (64, 80, 96, 100, 128, 160, 256)
# 2048: the timed rows, every configuration; 160: a ragged S (64-key
# tiles + 32), float16 operands only. S = 512 and the ragged S of the
# other types were cut (240 -> 100 configurations) to pay for the
# multi-GPU phases; the serve phases' prompts still run kernel 4 at 256
# and 512, and the card tests hold every type at ragged S
# (tests/test_torch_cuda_kernels.py).
FA_SEQS = (160, 2048)
FA_RAGGED_TYPES = (("float16", "float16"),)
# PR 19 added head dims 80 and 160 and paid for them here: the ragged S
# runs at those two only (the card tests hold every head dim at ragged S),
# and head dim 128, which the kernels phase and every serve phase time,
# keeps the configurations of the kernels line (FA_SUMMARY)
FA_RAGGED_DIMS = (80, 160)
# (operand type, Out_dtype): each operand type, and a float32 output of
# float16 operands
FA_TYPES = (("float16", "float16"), ("bfloat16", "bfloat16"),
            ("float32", "float32"), ("float16", "float32"))
FA_HEADS = 32       # B = 1, H = Hkv = 32: BitNet b1.58-3B's (and
                    # Llama-2-7B's) heads
FA_TUNED = ((64, 2048, True, "nnn", "float16"),
            (64, 512, True, "nnn", "bfloat16"),
            (64, 2048, False, "ntn", "float16"))


def fa_ulp(torch, dtype, out) -> float:
    """The element-wise limit's unit for kernel 4 against its plain
    version: the coarser of the operands' type (the kernel rounds P to
    it) and the output's (one rounding); float32 operands: 2^-18 (the
    3xTF32 kernel and the plain version sum in other orders)."""
    from bitblas_tpu_torch.testing import ATTN_ULP
    return max(ATTN_ULP.get(d, 2.0 ** -18) for d in (dtype, out))


def f32_truth(torch, Q, K, V, window, causal: bool, trans_k: bool):
    """Kernel 4's function in float64 on float32 operands: the plain
    version's scale, masks and walk with no rounding (the float32 rows'
    truth)."""
    if trans_k:
        K = K.permute(0, 3, 2, 1)
    B, S, H, D = Q.shape
    group = H // K.shape[2]
    q = Q.double() * (1.4426950408889634 / math.sqrt(D))
    k, v = (x.double().repeat_interleave(group, 2) for x in (K, V))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    key = torch.arange(S, device=Q.device)
    keep = torch.ones((S, S), dtype=torch.bool, device=Q.device)
    if causal:
        keep &= key[None] <= key[:, None]
    if window is not None:
        keep &= key[None] > key[:, None] - window
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return out / p.sum(-1).permute(0, 2, 1)[..., None]


# The float32 rows' limit against the plain version, in units of its
# element-wise limit: 3xTF32 products sum in other orders than the plain
# version's float32 ones, and at these scores the plain version is itself
# up to 2.13 of the limit from a float64 truth (D = 768). Set between the
# kernel's largest reading against the plain version (2.09, D = 768) and
# a 1xTF32 control's smallest (the plain version on TF32 matmuls); the
# readings are in PERF.md.
F32_PLAIN_LIMIT = 4.0


def f32_held(torch, out, ref, truth, u, plain):
    """The float32 rows' holding: the kernel within the element-wise limit
    (one `u` of |truth| plus 4 of the row's rms) of the float64 truth, and
    within F32_PLAIN_LIMIT of it of the plain version `ref`. `plain()`
    runs the plain version again on TF32 matmuls, the 1xTF32 control,
    read against `ref` beside the kernel. Returns (err over the truth's
    limit, err over the plain's, the plain version's own distance from the
    truth, the control's err over the plain's, held)."""
    from bitblas_tpu_torch.testing import attention_err
    to_truth = attention_err(out, truth, u, 4 * u)
    plain_gap = attention_err(ref, truth, u, 4 * u)
    to_plain = attention_err(out, ref, u, 4 * u)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = attention_err(plain(), ref, u, 4 * u)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return (to_truth, to_plain, plain_gap, control,
            to_truth <= 1.0 and to_plain <= F32_PLAIN_LIMIT)


def fa_bound(torch, B, S, H, Hkv, D, dtype, out, causal):
    """Kernel 4's bound: Q, K and V read once and O written once, and the
    products 4 B H D (the keys the rows attend: S (S + 1) / 2 causal, S^2
    dense) over the tensor-core rate (float16 / bfloat16) or, for float32,
    the least time for float32-accurate products: three TF32 products a
    product (3xTF32)."""
    e_in = torch.tensor([], dtype=dtype).element_size()
    e_out = torch.tensor([], dtype=out).element_size()
    nbytes = B * S * D * ((H + 2 * Hkv) * e_in + H * e_out)
    keys = S * (S + 1) // 2 if causal else S * S
    peak = F32X3_FLOPS_PER_S if dtype == torch.float32 else F16_FLOPS_PER_S
    return nbytes, bound(nbytes, 4.0 * B * H * D * keys, peak)


def check_flashatten(torch, flush):
    """Kernel 4 through ops/flashatten.FlashAtten on the card, at a grid of
    the configurations JAX's flash kernel takes (the rest -- odd head
    counts at D % 8 == 4, K^T at S % 8 != 0, float32 past D = 256, head
    dims to the general instance's cap -- are check_slice19_prefill's rows
    and tests/test_torch_cuda_kernels.py's): head dims 64 / 80 / 96 / 100 /
    128 / 256 on the wgmma instances and 160 on the general one, causal and
    dense, nnn and ntn, S = 2048 in float16, bfloat16, float32 and float16
    with a float32 Out_dtype (head dim 128: FA_SUMMARY's four), S = 160
    (ragged) in float16 at head dims 80 and 160 (B = 1, H = Hkv = 32, K
    amplified 3x). Each row: the operator's output against the
    plain version (testing.attention_err: one `fa_ulp` of |ref| plus 4
    of the row's rms), kernel_ms at the default tile (tuner/curated), each
    tile's ms (16-bit), plain_ms, SDPA's ms on the same operands (K^T
    transposed beforehand; the library yardstick, never called by the
    port), stream_ms and the bound. The launch counters are set to 0
    first and read after each configuration's one forward (the phase's
    launches, kept apart from the serve phases'). Then
    hardware_aware_finetune on three configurations at head dim 64, the
    one with two tiles (the winner against the default), and one tuned
    operator through the hint database."""
    from bitblas_tpu_torch.cache import OperatorCache
    from bitblas_tpu_torch.kernels.flash import (flash_attention_fwd,
                                                 flash_attention_plain)
    from bitblas_tpu_torch.ops import FlashAtten, FlashAttenConfig
    from bitblas_tpu_torch.testing import attention_err
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    t0 = time.perf_counter()
    B = 1
    H = Hkv = FA_HEADS
    launches = {}
    rows = []
    for D in FA_DIMS:
        for causal in (True, False):
            for layout in ("nnn", "ntn"):
                for S in FA_SEQS:
                    for dtype, out in FA_TYPES:
                        if S != 2048 and ((dtype, out) not in FA_RAGGED_TYPES
                                          or D not in FA_RAGGED_DIMS):
                            continue
                        if D == 128 and (D, causal, layout, dtype, out) \
                                not in FA_SUMMARY:
                            continue
                        dt, ot = getattr(torch, dtype), getattr(torch, out)
                        cfg = FlashAttenConfig(
                            batch=B, heads=H, seq_len=S, dim=D,
                            Q_dtype=dtype, Out_dtype=out, layout=layout,
                            is_causal=causal)
                        op = FlashAtten(cfg, device="cuda")
                        Q = torch.randn((B, S, H, D), generator=gen,
                                        device="cuda").to(dt)
                        K = (torch.randn((B, S, Hkv, D), generator=gen,
                                         device="cuda") * 3).to(dt)
                        V = torch.randn((B, S, Hkv, D), generator=gen,
                                        device="cuda").to(dt)
                        Kin = K.permute(0, 3, 2, 1).contiguous() \
                            if op.trans_k else K
                        flash_attention_fwd.launches = 0
                        flash_attention_fwd.variant_launches.clear()
                        got = op.forward(Q, Kin, V)
                        torch.cuda.synchronize()
                        for key, n in flash_attention_fwd.variant_launches \
                                .items():
                            launches[key] = launches.get(key, 0) + n
                        n = flash_attention_fwd.launches
                        if n != 1:
                            raise AssertionError(f"flashatten {cfg}: {n} "
                                                 f"launches of kernel 4")
                        tile = (op.block_q, op.block_kv)
                        kw = dict(causal=causal, trans_k=op.trans_k,
                                  out_dtype=ot, tile=tile)
                        ref = flash_attention_plain(Q, Kin, V, **kw)
                        u = fa_ulp(torch, dt, ot)
                        ratio = attention_err(got, ref, u, 4 * u)
                        err = (got.float() - ref.float()).abs().max().item()
                        held = ratio <= 1.0
                        if dt == torch.float32:
                            truth = f32_truth(torch, Q, Kin, V, None,
                                              causal, op.trans_k)
                            ratio, to_plain, plain_gap, control, held = \
                                f32_held(torch, got, ref, truth, u,
                                         lambda: flash_attention_plain(
                                             Q, Kin, V, **kw))
                            del truth
                        if not (held
                                and torch.isfinite(got).all().item()):
                            raise AssertionError(
                                f"flashatten D={D} S={S} causal={causal} "
                                f"{layout} {dtype} -> {out}: {ratio} of "
                                f"its limit (max abs err {err})")
                        nbytes, (b_ms, b_by) = fa_bound(
                            torch, B, S, H, Hkv, D, dt, ot, causal)
                        qt, kt, vt = (x.transpose(1, 2).contiguous()
                                      for x in (Q, K, V))
                        row = {
                            "phase": "flashatten", "D": D, "S": S,
                            "causal": causal, "layout": layout,
                            "dtype": dtype, "out": out, "B": B, "H": H,
                            "Hkv": Hkv, "tile": list(tile),
                            "max_abs_err": err, "err_over_tol": ratio,
                            "ulp": u, "elementwise": "ulp |ref| + 4 ulp "
                            "rms(row)",
                            **({"ref": "float64 truth",
                                "err_over_tol_plain": to_plain,
                                "plain_over_tol": plain_gap,
                                "tf32x1_over_tol_plain": control}
                               if dt == torch.float32 else {}),
                            "kernel_ms": time_ms(torch, lambda: op.forward(
                                Q, Kin, V), 20, flush),
                            "plain_ms": time_ms(
                                torch, lambda: flash_attention_plain(
                                    Q, Kin, V, **kw), 3, flush),
                            "library_ms": time_ms(
                                torch, lambda: F.scaled_dot_product_attention(
                                    qt, kt, vt, is_causal=causal), 10, flush),
                            "stream_ms": time_ms(torch, _stream(torch, nbytes),
                                                 20, flush),
                            "bound_ms": b_ms, "bound_by": b_by}
                        if dt != torch.float32:
                            row["tile_ms"] = {
                                f"{t[0]}x{t[1]}": time_ms(
                                    torch, lambda t=t: flash_attention_fwd(
                                        Q, Kin, V, **{**kw, "tile": t}), 20,
                                    flush)
                                for t in op.candidates}
                        emit(row)
                        rows.append(row)
                        del Q, K, V, Kin, got, ref, qt, kt, vt
    torch.cuda.empty_cache()
    # the tuned rows: hardware_aware_finetune's winner against the default
    tuned = []
    for D, S, causal, layout, dtype in FA_TUNED:
        cfg = FlashAttenConfig(batch=B, heads=H, seq_len=S, dim=D,
                               Q_dtype=dtype, Out_dtype=dtype, layout=layout,
                               is_causal=causal)
        default = FlashAtten(cfg, device="cuda")
        op = FlashAtten(cfg, device="cuda", enable_tuning=True)
        times = {f"{t[0]}x{t[1]}": s * 1e3
                 for t, s in op.tune_results.items()}
        row = {"phase": "flashatten_tuned", "D": D, "S": S, "causal": causal,
               "layout": layout, "dtype": dtype, "H": H,
               "winner": op.hints[0].short_name(),
               "winner_ms": op.tune_results[(op.block_q, op.block_kv)] * 1e3,
               "default": default.hints[0].short_name(),
               "default_ms": op.tune_results[(default.block_q,
                                              default.block_kv)] * 1e3,
               "candidates_ms": times}
        emit(row)
        tuned.append((cfg, op))
    # a tuned operator through the hint database: hints equal, unpinned,
    # the same output bit for bit
    db = tempfile.mkdtemp(prefix="bitblas_tpu_torch_db_")
    try:
        cfg, op = tuned[0]
        cache = OperatorCache()
        cache.add(cfg, op)
        cache.save_into_database(db)
        back = OperatorCache()
        if back.load_from_database(db) != 1:
            raise AssertionError("flashatten: the tuned operator did not "
                                 "load from the database")
        again = back.get(cfg)
        args = op._example_args()
        if not (again.hints == op.hints and not again.tuned_hints
                and torch.equal(again.forward(*args), op.forward(*args))):
            raise AssertionError("flashatten: the reloaded operator differs")
    finally:
        shutil.rmtree(db)
    emit({"phase": "flashatten_summary", "configs": len(rows),
          "worst_err_over_tol": max(r["err_over_tol"] for r in rows),
          "launches": launches, "database_round_trip": True,
          "seconds": time.perf_counter() - t0})
    return rows, launches


def bitnet_b158_3b(num_layers: int):
    from bitblas_tpu_torch.models.quant_llama import LlamaConfig
    # 1bitLLM/bitnet_b1_58-3B config.json widths: hidden 3200,
    # intermediate 8640, 26 layers, 32 heads and KV heads (head dim 100),
    # vocab 32002, rope_theta 10000, rms_norm_eps 1e-5, 2048 positions;
    # every projection a ternary W2A8 BitLinear
    return LlamaConfig(hidden_size=3200, intermediate_size=8640,
                       num_heads=32, num_kv_heads=32, num_layers=num_layers,
                       vocab_size=32002, rope_theta=10000.0,
                       rms_norm_eps=1e-5)


D100 = "flash_attention_fwd float16 d100"   # kernel 4 at head dim 100
BITNET_3B_PROMPTS = (200, 450, 1000, 1900)  # buckets 256 / 512 / 1024 / 2048
BITNET_3B_MAX_SEQ = 2048
BITNET_3B_PHASE = ("serve_bitnet_3b", "token", {},
                   ("dequant_matmul_i2", DECODE["int2"], TILED["int2"],
                    "weight_decode_int8", D100))


def check_reference_bitnet_3b(torch, counters):
    """BITNET_3B_REF_LAYERS BitNet layers at b1.58-3B's widths, card
    against the same weights
    on the CPU: prefill in buckets 256 and 512 (kernel 4 at head dim 100
    on the card, its plain version on the CPU), then teacher-forced decode
    steps (the plain length-masked attention at D = 100 on both, as in
    JAX), and the token engine with four greedy requests. Hidden states
    are held to BITNET_3B_HIDDEN of the largest, the prefill's after the
    first layer to BITNET_3B_LAYER1_RMS (rms; the number that rejects the
    bfloat16 glue faults), logits to the BitNet limits, tokens equal
    wherever the CPU's top-2 margin exceeds the limit (as
    check_bitnet_reference)."""
    from bitblas_tpu_torch.kernels.flash import flash_attention_fwd
    from bitblas_tpu_torch.models.bitnet import BitNetLlama
    t0 = time.perf_counter()
    cfg = bitnet_b158_3b(BITNET_3B_REF_LAYERS)
    gpu, cpu = _card_and_cpu(
        torch, lambda **kw: BitNetLlama(cfg, opt_m=BITNET_BUCKETS, **kw),
        seed=41)
    heads = _reference_heads(torch, cfg)
    for c in counters:
        c.launches = 0
        if hasattr(c, "variant_launches"):
            c.variant_launches.clear()
    bitlinear_exact(torch, gpu, cpu)
    head = heads["cpu"]
    for S in (256, 512):
        x = _reference_input(torch, cfg, S=S)
        card = _run_steps(torch, cfg, gpu, x, "cuda")
        ref = _run_steps(torch, cfg, cpu, x, "cpu")
        row = {"phase": "reference_bitnet_3b",
               "layers": BITNET_3B_REF_LAYERS, "prompt": S,
               "decode_steps": 4, "hidden_tol": BITNET_3B_HIDDEN,
               "layer1_rms_tol": BITNET_3B_LAYER1_RMS,
               "rel_tol": BITNET_LOGIT_MAX, "rms_rel_tol": BITNET_LOGIT_RMS}
        decided = 0
        for i, key in enumerate(("prefill", "decode")):
            a, b = card[i], ref[i]
            if not torch.isfinite(a).all():
                raise AssertionError(f"reference_bitnet_3b: non-finite "
                                     f"{key} hidden on the card")
            row[key + "_hidden"] = _gap(a, b)
            la, lb = (head.logits(t[-64:] if key == "prefill" else t)
                      for t in (a, b))
            row[key + "_logits"] = _gap(la, lb)
            n, _ = _decided(la, lb, BITNET_LOGIT_MAX * lb.abs().max().item())
            decided += n
        row["tokens_decided"] = decided
        row["layer1_hidden"] = _gap(_layer1_hidden(torch, gpu, x, "cuda"),
                                    _layer1_hidden(torch, cpu, x, "cpu"))
        row["d100_launches"] = flash_attention_fwd.variant_launches.get(
            "float16 d100", 0)
        emit(row)
        bad = [k for k in ("prefill_hidden", "decode_hidden")
               if row[k]["max_rel_err"] > BITNET_3B_HIDDEN] + [
            "layer1_hidden"] * (row["layer1_hidden"]["rms_rel_err"]
                                > BITNET_3B_LAYER1_RMS) + [
            k for k in ("prefill_logits", "decode_logits")
            if row[k]["max_rel_err"] > BITNET_LOGIT_MAX
            or row[k]["rms_rel_err"] > BITNET_LOGIT_RMS]
        if bad:
            raise AssertionError(f"reference_bitnet_3b S={S}: {bad} over "
                                 f"their limits: {row}")
    if flash_attention_fwd.variant_launches.get("float16 d100", 0) <= 0:
        raise AssertionError("reference_bitnet_3b: kernel 4 at head dim 100 "
                             "did not launch")
    compare_engines(torch, cfg, gpu, cpu, tag="_bitnet_3b", heads=heads,
                    rel_tol=BITNET_ENGINE_MAX,
                    min_decided=BITNET_MIN_DECIDED[1])
    del gpu, cpu
    torch.cuda.empty_cache()
    emit({"phase": "reference_bitnet_3b_summary",
          "layers": BITNET_3B_REF_LAYERS,
          "reduced": {"layers": f"26 -> {BITNET_3B_REF_LAYERS}: a CPU plain "
                                "reference"},
          "seconds": time.perf_counter() - t0})


def bitnet_3b_serving_model(torch):
    """All 26 layers of BitNet b1.58-3B (W2A8, random ternary weights
    drawn on the card from a seed), an LMHead of vocab 32002, four
    prompts of 200 / 450 / 1000 / 1900 tokens (buckets 256 / 512 / 1024
    / 2048, every one through kernel 4 at head dim 100), max_seq_len
    2048: a bf16 slot cache of 4 x 2048 rows."""
    import numpy as np
    from bitblas_tpu_torch.models.bitnet import BitNetLlama
    from bitblas_tpu_torch.models.hf_import import LMHead

    t0 = time.perf_counter()
    cfg = bitnet_b158_3b(26)
    model = BitNetLlama(cfg, opt_m=BITNET_BUCKETS, device="cuda", seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    V, Hd = cfg.vocab_size, cfg.hidden_size
    head = LMHead(
        embed=(torch.randn((V, Hd), generator=gen, device="cuda") * 0.05
               ).half(),
        final_norm=torch.ones(Hd, device="cuda"),
        lm_head=torch.randn((V, Hd), generator=gen, device="cuda") * 0.05,
        norm_eps=cfg.rms_norm_eps, device="cuda")
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, n).astype(np.int32)
               for n in BITNET_3B_PROMPTS]
    packed = sum(t.numel() * t.element_size()
                 for n, t in model.named_buffers()
                 if "qweight" in n or n.endswith(".sw"))
    return {"cfg": cfg, "model": model, "head": head, "prompts": prompts,
            "pair": [], "init_s": time.perf_counter() - t0,
            "name": "BitNet b1.58-3B widths, W2A8", "weight_bytes": packed,
            "max_seq_len": BITNET_3B_MAX_SEQ}


def bitnet_3b_phases(torch, counters, routes=None):
    """reference_bitnet_3b, then serve_bitnet_3b (its launches)."""
    check_reference_bitnet_3b(torch, counters)
    ctx = bitnet_3b_serving_model(torch)
    routes = routes or RouteRecorder()
    with routes:
        row = serve(torch, ctx, counters, *BITNET_3B_PHASE, routes=routes)
    del ctx
    torch.cuda.empty_cache()
    return row


# -- Mixtral-8x7B: the routed MoE FFN (models/quant_moe) ---------------------

# Kernel 1 at the experts' shapes (N, K): gate / up, down
MIXTRAL_EXPERT_SHAPES = ((14336, 4096), (4096, 14336))
# an expert's M: the capacity of a 4-slot decode step (moe_capacity's floor
# of 8: the split-K decode instance), a prefill capacity on the tiled
# instance (bucket 256 at capacity factor 4, reference_mixtral's engine)
# and one on the materialize plan (bucket 4096 at factor 2, serve_mixtral)
MIXTRAL_KERNEL_MS = (8, 256)
MIXTRAL_MATERIALIZE_M = 2048
# mistralai/Mixtral-8x7B-v0.1 config.json
MIXTRAL_8X7B_HF = {"hidden_size": 4096, "intermediate_size": 14336,
                   "num_attention_heads": 32, "num_key_value_heads": 8,
                   "num_hidden_layers": 32, "vocab_size": 32000,
                   "rms_norm_eps": 1e-5, "rope_theta": 1e6,
                   "num_local_experts": 8, "num_experts_per_tok": 2,
                   "sliding_window": None, "model_type": "mixtral"}
# the packed bytes of the 32-layer model: 8 experts x 3 projections x 32
# layers x 31,195,136 (14336 x 4096 / 2 words, 2 x 32 x 14336 x 2 scales
# and zeros) + 32 x 22,282,240 (q / k / v / o)
MIXTRAL_WEIGHT_BYTES = 8 * 3 * 32 * 31195136 + 32 * 22282240


def mixtral_8x7b(num_layers: int, capacity_factor: float = 2.0):
    """Mixtral-8x7B-v0.1's published widths (no sliding window), uint4
    GPTQ group 128 with original zeros under float16 activations (the
    TheBloke/Mixtral-8x7B-v0.1-GPTQ layout), the import's capacity factor
    2.0."""
    from bitblas_tpu_torch.models.hf_import_mixtral import (
        mixtral_config_from_hf)
    return mixtral_config_from_hf(
        dict(MIXTRAL_8X7B_HF, num_hidden_layers=num_layers),
        capacity_factor=capacity_factor)


def check_dequant_mixtral(torch, flush):
    """Kernel 1 uint4 x f16 g128 at the experts' shapes, M = 8 (the split-K
    decode instance) and 256 (the default tiled instance), as
    check_dequant holds it; then the materialize plan at M = 2048: kernel
    2's weight bit-equal to its plain decode (a row of its own, timed
    against its byte bound), the plan's product bit-equal to cuBLAS's on
    that weight and within one f16 ulp, or 4e-3 of the largest output, of
    the float32 plain version (cuBLAS's sums over K = 14336 stray past one
    ulp). Returns (kernel 1's rows, kernel 2's rows)."""
    from bitblas_tpu_torch.kernels.dequant_matmul import (
        dequant_matmul_u4_plain)
    from bitblas_tpu_torch.kernels.materialize import (
        materialize_matmul, weight_decode_u4, weight_decode_u4_plain)
    from bitblas_tpu_torch.kernels.spec import KernelSpec
    from bitblas_tpu_torch.ops.matmul_config import MatmulConfig
    k1 = check_dequant(torch, flush, shapes=MIXTRAL_EXPERT_SHAPES,
                       ms=MIXTRAL_KERNEL_MS, seed=61,
                       extra={"model": "Mixtral-8x7B experts"})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(62)
    M = MIXTRAL_MATERIALIZE_M
    k2 = []
    for (N, K) in MIXTRAL_EXPERT_SHAPES:
        G = K // 128
        qw = _words(torch, gen, (N, K // 8))
        sc = (torch.rand((G, N), generator=gen, device="cuda") * 0.01
              + 0.005).half()
        zr = torch.randint(0, 16, (G, N), generator=gen, device="cuda").half()
        A = torch.randn((M, K), generator=gen, device="cuda").half()
        wbytes = N * K / 2 + 2 * G * N * 2
        nbytes = wbytes + N * K * 2
        b_ms, b_by = bound(nbytes, 0.0)
        Wp = weight_decode_u4_plain(qw, sc, zr)
        k2.append(_exact_row(
            torch, "weight_decode_u4", weight_decode_u4(qw, sc, zr), Wp,
            {"N": N, "K": K, "out": "float16", "model": "Mixtral-8x7B "
             "experts", "bound_ms": b_ms, "bound_by": b_by},
            {"kernel_ms": (lambda: weight_decode_u4(qw, sc, zr), 20),
             "plain_ms": (lambda: weight_decode_u4_plain(qw, sc, zr), 3),
             "library_ms": (None, 0),
             "stream_ms": (_stream(torch, nbytes), 20)}, flush))
        spec = KernelSpec.from_config(MatmulConfig(N=N, K=K, **W4A16), M)
        out = materialize_matmul(spec, A, qw, sc, zr)
        lib = torch.matmul(A, Wp.T)
        ref = dequant_matmul_u4_plain(A, qw, sc, zr)
        torch.cuda.synchronize()
        ulps = f16_ulps(torch, out, ref)
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        if not (torch.equal(out, lib) and torch.isfinite(out).all().item()
                and (ulps <= 1 or err <= 4e-3 * scale)):
            raise AssertionError(f"materialize M={M} N={N} K={K}: {ulps} "
                                 f"ulps, err {err} (largest {scale}), "
                                 f"cuBLAS-equal {torch.equal(out, lib)}")
        b_ms, b_by = bound(M * K * 2 + wbytes + M * N * 2, 2.0 * M * N * K)
        row = {"phase": "kernels", "kernel": "materialize_u4", "M": M,
               "N": N, "K": K, "model": "Mixtral-8x7B experts",
               "ulps": ulps, "max_abs_err": err,
               "max_rel_err": err / max(scale, 1e-30),
               "route_ms": time_ms(torch, lambda: materialize_matmul(
                   spec, A, qw, sc, zr), 20, flush),
               "plain_ms": time_ms(torch, lambda: dequant_matmul_u4_plain(
                   A, qw, sc, zr), 3, flush),
               "library_ms": time_ms(torch, lambda: torch.matmul(A, Wp.T),
                                     20, flush),
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
    return k1, k2


MIXTRAL_REF_LAYERS = 1
# The reference's capacity factor: n_experts / top_k, so an expert's buffer
# holds every token and neither side drops one (the import's 2.0 can drop,
# and a route that flips on one side would then move other tokens' slots)
MIXTRAL_REF_FACTOR = 4.0
# A route flips where the CPU's k-th and (k+1)-th router probabilities lie
# closer than the card's and the CPU's probabilities differ; each flip's
# CPU margin between those two must lie under this: 2.5x the largest
# card-CPU probability gap read on an H100 (7.9e-4, reference_mixtral's
# engine run; one flip there, at a margin of 8.1e-8)
MIXTRAL_FLIP_MARGIN = 2e-3


def mixtral_gptq_state(torch, num_layers: int, seed: int):
    """An AutoGPTQ v1 (desc_act=False) Mixtral state dict at the published
    widths, drawn on the card from `seed`: random qweight words (every
    code occurs), zero point 8 (v1 stores 7), the attention's scales 0.001
    +- 0.0002 and the experts' |N(0, 1)| * 0.004 + 0.004 (the JAX
    fixtures'), a router [8, 4096] of N(0, 1) * 0.05, unit norms,
    embedding and lm_head * 0.05."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    H, I, E = 4096, 14336, 8
    projs = [(f"self_attn.{n}_proj", H, N, False) for n, N in
             (("q", H), ("k", 1024), ("v", 1024), ("o", H))]
    projs += [(f"block_sparse_moe.experts.{e}.{w}", K, N, True)
              for e in range(E) for w, K, N in (("w1", H, I), ("w3", H, I),
                                                ("w2", I, H))]
    state = {}
    for i in range(num_layers):
        base = f"model.layers.{i}"
        for name, K, N, expert in projs:
            key = f"{base}.{name}"
            state[f"{key}.qweight"] = _words(torch, gen, (K // 8, N))
            state[f"{key}.qzeros"] = torch.full(
                (K // 128, N // 8), 0x77777777, dtype=torch.int32,
                device="cuda")
            s = torch.randn((K // 128, N), generator=gen, device="cuda")
            s = s.abs() * 0.004 + 0.004 if expert else s * 0.0002 + 0.001
            state[f"{key}.scales"] = s.half()
        state[f"{base}.block_sparse_moe.gate.weight"] = (torch.randn(
            (E, H), generator=gen, device="cuda") * 0.05).half()
        for norm in ("input_layernorm", "post_attention_layernorm"):
            state[f"{base}.{norm}.weight"] = torch.ones(H, device="cuda")
    state["model.embed_tokens.weight"] = (torch.randn(
        (32000, H), generator=gen, device="cuda") * 0.05).half()
    state["model.norm.weight"] = torch.ones(H, device="cuda")
    state["lm_head.weight"] = torch.randn((32000, H), generator=gen,
                                          device="cuda") * 0.05
    return state


class RouteReplay:
    """While installed, the routed FFN's top-k (models/quant_moe
    .top_k_gates) records each card call's experts and router
    probabilities, and each CPU call, in the same order, takes the card's
    experts (its gates from its own probabilities): both sides then route
    every token alike, so hidden states and logits compare on every
    token. A flip is a row whose own CPU top-k differs from the card's;
    each keeps the CPU's margin between its k-th and (k+1)-th
    probability."""

    def __init__(self):
        from bitblas_tpu_torch.models import quant_moe
        self.mod, self.orig = quant_moe, quant_moe.top_k_gates
        self.card, self.margins = [], []
        self.cpu_calls = self.rows = 0
        self.prob_gap = 0.0

    def __enter__(self):
        import torch
        orig = self.orig

        def replay(logits, top_k):
            gates, experts = orig(logits, top_k)
            probs = torch.softmax(logits.float(), dim=-1)
            if logits.device.type != "cpu":
                self.card.append((experts.cpu(), probs.cpu()))
                return gates, experts
            card_e, card_p = self.card[self.cpu_calls]
            self.cpu_calls += 1
            if card_e.shape != experts.shape:
                raise AssertionError(f"route call {self.cpu_calls}: card "
                                     f"{tuple(card_e.shape)}, CPU "
                                     f"{tuple(experts.shape)}")
            self.rows += experts.shape[0]
            self.prob_gap = max(self.prob_gap,
                                (card_p - probs).abs().max().item())
            flip = (card_e.sort(-1).values
                    != experts.sort(-1).values).any(-1)
            if flip.any():
                top = probs.sort(-1, descending=True).values
                self.margins += (top[:, top_k - 1] - top[:, top_k])[
                    flip].tolist()
            g = probs.gather(1, card_e)
            return g / g.sum(-1, keepdim=True), card_e

        self.mod.top_k_gates = replay
        return self

    def __exit__(self, *exc):
        self.mod.top_k_gates = self.orig

    def take(self) -> dict:
        """The readings since the last take: calls, rows, flips and their
        margins, the largest |card - CPU| router probability; fails on a
        flip whose margin is not under MIXTRAL_FLIP_MARGIN or on a card
        call the CPU did not replay."""
        if self.cpu_calls != len(self.card):
            raise AssertionError(f"{len(self.card)} card route calls, "
                                 f"{self.cpu_calls} replayed")
        out = {"route_calls": self.cpu_calls, "routed_rows": self.rows,
               "route_flips": len(self.margins),
               "flip_cpu_margins": sorted(self.margins),
               "max_router_prob_gap": self.prob_gap}
        if any(m >= MIXTRAL_FLIP_MARGIN for m in self.margins):
            raise AssertionError(f"a route flipped at a CPU top-k margin "
                                 f">= {MIXTRAL_FLIP_MARGIN}: {out}")
        self.card, self.margins = [], []
        self.cpu_calls = self.rows = 0
        self.prob_gap = 0.0
        return out


def check_reference_mixtral(torch):
    """Mixtral-8x7B's widths, one layer (depth cut: the CPU plain
    reference), imported from a synthetic AutoGPTQ v1 state dict through
    load_quant_mixtral_from_hf_gptq on the card and on the CPU, capacity
    factor MIXTRAL_REF_FACTOR (no token can drop): one sequence (prefill
    in bucket 512, the experts on the materialize plan; 4 teacher-forced
    decode steps on the decode instance) and the token engine (prompts in
    buckets 256 and 512: the experts on the tiled instance and the
    materialize plan), card against CPU at reference_steps' and
    compare_engines' tolerances, the CPU replaying the card's routes
    (RouteReplay: route flips counted, each under MIXTRAL_FLIP_MARGIN)."""
    from bitblas_tpu_torch.models.hf_import_mixtral import (
        load_quant_mixtral_from_hf_gptq)
    t0 = time.perf_counter()
    hf = dict(MIXTRAL_8X7B_HF, num_hidden_layers=MIXTRAL_REF_LAYERS)
    state = mixtral_gptq_state(torch, MIXTRAL_REF_LAYERS, seed=51)
    kw = dict(capacity_factor=MIXTRAL_REF_FACTOR)
    gpu, gh = load_quant_mixtral_from_hf_gptq(state, hf, device="cuda",
                                              **kw)
    cpu, ch = load_quant_mixtral_from_hf_gptq(
        {k: v.cpu() for k, v in state.items()}, hf, device="cpu", **kw)
    del state
    torch.cuda.empty_cache()
    routes = {}
    with CpuWeightMemo(), RouteReplay() as replay:
        reference_steps(torch, gpu.cfg, gpu, cpu, "reference_mixtral")
        routes["sequence"] = replay.take()
        compare_engines(torch, gpu.cfg, gpu, cpu, tag="_mixtral",
                        heads={"cuda": gh, "cpu": ch})
        routes["engine"] = replay.take()
    del gpu, cpu
    torch.cuda.empty_cache()
    emit({"phase": "reference_mixtral_routes", "layers": MIXTRAL_REF_LAYERS,
          "capacity_factor": MIXTRAL_REF_FACTOR,
          "flip_margin_limit": MIXTRAL_FLIP_MARGIN, **routes,
          "reduced": {"layers": f"32 -> {MIXTRAL_REF_LAYERS}: the CPU plain "
                                f"reference (5.6 GB of decoded float32 "
                                f"expert weights a layer)",
                      "capacity_factor": f"2.0 -> {MIXTRAL_REF_FACTOR}: no "
                                         f"drops on either side"},
          "seconds": time.perf_counter() - t0})
    return routes


def mixtral_serving_model(torch):
    """32 layers at Mixtral-8x7B-v0.1's widths, W4 g128 original zeros,
    float16 activations, 8 experts top-2 at capacity factor 2.0, random
    weights drawn on the card from a seed, an LMHead of vocab 32000,
    Mistral's four prompts (1000 / 3000 / 4500 / 6000 tokens), max_seq_len
    8192."""
    import numpy as np
    from bitblas_tpu_torch.models.hf_import import LMHead
    from bitblas_tpu_torch.models.quant_moe import QuantMixtral

    from bitblas_tpu_torch.models.quant_llama import layer_forward

    t0 = time.perf_counter()
    cfg = mixtral_8x7b(32)
    model = QuantMixtral(cfg, device="cuda", seed=0)
    # JAX's expert fixture scales (|N(0, 1)| * 0.004 + 0.004) grow the
    # float16 residual stream ~10^3-fold a layer at hidden 4096
    # (reference_mixtral's one layer takes inputs of |x| < 2.5 to ~700),
    # past float16's range within three layers: the served experts take
    # the attention's contractive scales, N(0, 1) * 0.0002 + 0.001
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    with torch.no_grad():
        for layer in model.layers:
            for name in ("gate", "up", "down"):
                sc = getattr(layer.moe, f"{name}_scales")
                sc.copy_(torch.randn(sc.shape, generator=gen, device="cuda")
                         * 0.0002 + 0.001)
    gen.manual_seed(5)
    V, Hd = cfg.vocab_size, cfg.hidden_size
    head = LMHead(
        embed=(torch.randn((V, Hd), generator=gen, device="cuda") * 0.05
               ).half(),
        final_norm=torch.ones(Hd, device="cuda"),
        lm_head=torch.randn((V, Hd), generator=gen, device="cuda") * 0.05,
        norm_eps=cfg.rms_norm_eps, device="cuda")
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, n).astype(np.int32)
               for n in MISTRAL_PROMPTS]
    packed = sum(t.numel() * t.element_size()
                 for n, t in model.named_buffers() if "qweight" in n or
                 "scales" in n or "zeros" in n)
    if packed != MIXTRAL_WEIGHT_BYTES:
        raise AssertionError(f"serve_mixtral: {packed} packed weight bytes, "
                             f"reckoned {MIXTRAL_WEIGHT_BYTES}")
    init_s = time.perf_counter() - t0
    # the residual stream through the 32 layers stays finite in float16:
    # the largest |hidden| after each layer on a 64-token prompt
    x = head.embed_tokens(prompts[0][:64])[None]
    pos = torch.arange(64, device="cuda")[None]
    absmax = []
    for layer in model.layers:
        x = layer_forward(layer, x, pos)
        absmax.append(x.float().abs().max().item())
    emit({"phase": "mixtral_residual", "tokens": 64,
          "absmax_by_layer": absmax})
    if not all(math.isfinite(a) for a in absmax):
        raise AssertionError(f"serve_mixtral: the residual stream overflows "
                             f"float16: {absmax}")
    return {"cfg": cfg, "model": model, "head": head, "prompts": prompts,
            "pair": [], "init_s": init_s,
            "name": "Mixtral-8x7B-v0.1 widths, W4 g128, f16, 8 experts "
                    "top-2, capacity factor 2.0",
            "weight_bytes": packed, "max_seq_len": MISTRAL_MAX_SEQ}


# decode steps run every expert at M = 8 (the decode instance), prefill
# buckets 1024 / 4096 / 8192 at capacities 512 / 2048 / 4096 (the
# materialize plan); attention kernels 4 and 5 at f16, no window
MIXTRAL_PHASE = ("serve_mixtral", "token", {},
                 ("dequant_matmul_u4", DECODE["uint4"], "weight_decode_u4",
                  "flash_attention_fwd", "flash_decode"))


def mixtral_entries(k1, k2, shapes):
    """The kernels line's rows of the experts' shapes: kernel 1's decode
    and tiled instances and kernel 2, and their launches in serve_mixtral
    at that (N, K) (`shapes`: RouteRecorder's counts by plan and shape),
    as (entries, {name: launches})."""
    out, launches = [], {}
    for N, K in MIXTRAL_EXPERT_SHAPES:
        for kind, M, src in (("decode", 8, "dequant_matmul.cu"),
                             ("tiled", 256, "dequant_wgmma.cuh")):
            rows = [r for r in k1 if (r["N"], r["K"], r["M"]) == (N, K, M)]
            name = f"dequant_matmul_u4 {kind} {N}x{K}"
            out.append((name, src, "dequant_matmul.py:231", rows, rows[0],
                        f"M={M} N={N} K={K} uint4 x f16 g128, Mixtral-8x7B "
                        f"expert"))
            launches[name] = shapes.get(f"uint4 {kind} {N}x{K}", 0)
        rows = [r for r in k2 if (r["N"], r["K"]) == (N, K)]
        name = f"weight_decode_u4 {N}x{K}"
        out.append((name, "weight_decode.cu", "materialize.py:227", rows,
                    rows[0], f"N={N} K={K} uint4 -> f16 g128, Mixtral-8x7B "
                    f"expert"))
        launches[name] = shapes.get(f"uint4 materialize {N}x{K}", 0)
    return out, launches


def mixtral_phases(torch, counters, flush, routes=None):
    """`--mixtral` (and the full run's pieces): kernel 1 and 2 at the
    experts' shapes, reference_mixtral, serve_mixtral. Returns (kernel 1
    rows, kernel 2 rows, serve_mixtral's row)."""
    k1, k2 = check_dequant_mixtral(torch, flush)
    check_reference_mixtral(torch)
    routes = routes or RouteRecorder()
    ctx = mixtral_serving_model(torch)
    with routes:
        row = serve(torch, ctx, counters, *MIXTRAL_PHASE, routes=routes)
    del ctx
    torch.cuda.empty_cache()
    return k1, k2, row


# -- the model tools: float checkpoints quantized on the card (GPTQ / RTN),
# speculative decoding, BitNet's QAT forward --------------------------------

# meta-llama/Llama-2-7b-hf config.json
LLAMA2_7B_HF = {"hidden_size": 4096, "intermediate_size": 11008,
                "num_attention_heads": 32, "num_key_value_heads": 32,
                "num_hidden_layers": 32, "vocab_size": 32000,
                "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
                "model_type": "llama"}
# the packed bytes of 32 uint4 g128 layers at Llama-2-7B's widths: serve's
LLAMA_WEIGHT_BYTES = 3440377856
QUANT_CALIB = (2, 512)       # calibration sequences x tokens
QUANT_SAMPLE_LAYERS = (0, 31)  # layers whose projections are held to RTN
# reference_quantize: one layer's GPTQ card against CPU. The card's sweep
# run on the CPU's own weights, Hessians and U = chol(H^-1)^T must give
# the CPU's codes, scales and zeros bit for bit (the sweep alone, apart
# from calibration and the float64 factorization, whose last bits differ
# between LAPACK and cuSOLVER).
# The layer objective (tr(E H E^T) summed over its seven projections, each
# side on its own calibration) within this relative gap of the CPU's: read
# 5.5e-4 on an NVIDIA H100 80GB HBM3 at 700 W, where GPTQ sits at 0.1 of
# RTN's. The phase also reports the card's sweep on the CPU's Hessians
# rounded to float32 (how far a float32-sized change of H moves the codes
# and the objective) and with U = chol(H^-1)^T rounded to float32 (a
# planted precision fault).
QUANT_REF_OBJECTIVE = 1e-3
SPEC_PROMPT = 256            # bucket 256: the prompt prefills through kernel 4
SPEC_NEW = 64
SPEC_NEW_RTN = 16            # draft (b): the RTN model (low acceptance)
SPEC_NEW_UNCACHED = 16
SPEC_GAMMA = 4
# speculative: speculation's greedy tokens equal `generate`'s up to the
# first difference, which must fall at a position where the top-2 margin
# of the logits generate decided by is under this limit (a near tie the
# card's arithmetic can flip); so must every position where draft (a),
# the target itself, loses a proposal. The card's change of that top-2 gap
# between generate's path (decode_step, kernel 5) and decode_chunk's at M
# = gamma + 1 (the verify's: torch attention) read 0.086 on an NVIDIA H100
# 80GB HBM3 at 700 W, and 0.106 between the full forward and decode_chunk
# (an earlier form of the check). The limit sits at ~2.9x the reading the
# run takes and ~2.4x the larger one; each run's reading must stay under
# it.
# At least SPEC_MIN_DECIDED tokens above the limit are compared.
SPEC_FLIP_MARGIN = 0.25
SPEC_MIN_DECIDED = 16
# quantize_mixtral: the expert kept out of every top-2 by a -10 router
# weight on channel 0, which every embedding holds at this value
ZERO_EXPERT = 3
ZERO_CHANNEL_VALUE = 2.0


def float_llama_state(torch, hf: dict, seed: int, experts: bool = False):
    """A float16 HF-layout state dict drawn on the card, as JAX's
    tests/test_quantize.py fixture draws it: projections N(0, 0.02),
    embedding and lm_head N(0, 0.05), norms of 1; with `experts` a
    Mixtral layer's router [E, H] N(0, 0.05) and experts w1 / w3 / w2."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    H, I, V = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    kv = hf["num_key_value_heads"] * H // hf["num_attention_heads"]

    def w(n, k, scale=0.02):
        return (torch.randn((n, k), generator=gen, device="cuda")
                * scale).half()

    state = {"model.embed_tokens.weight": w(V, H, 0.05),
             "model.norm.weight": torch.ones(H, device="cuda").half(),
             "lm_head.weight": w(V, H, 0.05)}
    for i in range(hf["num_hidden_layers"]):
        b = f"model.layers.{i}"
        state[f"{b}.self_attn.q_proj.weight"] = w(H, H)
        state[f"{b}.self_attn.k_proj.weight"] = w(kv, H)
        state[f"{b}.self_attn.v_proj.weight"] = w(kv, H)
        state[f"{b}.self_attn.o_proj.weight"] = w(H, H)
        if experts:
            E = hf["num_local_experts"]
            state[f"{b}.block_sparse_moe.gate.weight"] = w(E, H, 0.05)
            for e in range(E):
                x = f"{b}.block_sparse_moe.experts.{e}"
                state[f"{x}.w1.weight"] = w(I, H)
                state[f"{x}.w3.weight"] = w(I, H)
                state[f"{x}.w2.weight"] = w(H, I)
        else:
            state[f"{b}.mlp.gate_proj.weight"] = w(I, H)
            state[f"{b}.mlp.up_proj.weight"] = w(I, H)
            state[f"{b}.mlp.down_proj.weight"] = w(H, I)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            state[f"{b}.{norm}.weight"] = torch.ones(H, device="cuda").half()
    return state


class QuantRecorder:
    """While installed, each quantization call of the quantizers
    (models/quantize_hf's quant function: {name: weight} and a Hessian or
    None) whose index is in `keep` (all when None) keeps {name: (float
    weight, Hessian, QuantizedWeight)}, and in `inverses` the inverse
    factor U its GPTQ computed on the CPU (None on the card or for RTN);
    each layer's log line, after a device sync, stamps the end of its
    seconds."""

    def __init__(self, keep=None):
        from bitblas_tpu_torch.models import quantize_hf
        from bitblas_tpu_torch.quantization import gptq
        self.mod, self.orig = quantize_hf, quantize_hf._make_quant
        self.gptq, self.inverse = gptq, gptq._inverse_factor
        self.keep, self.calls, self.index = keep, [], 0
        self.inverses, self.pending = [], []
        self.stamps = []

    def __enter__(self):
        import logging
        import torch
        from bitblas_tpu_torch.common import get_logger
        orig, rec = self.orig, self

        def make(*args):
            quant = orig(*args)

            def recording(weights, hess):
                rec.pending.clear()
                out = quant(weights, hess)
                if rec.keep is None or rec.index in rec.keep:
                    rec.calls.append({n: (weights[n], hess, out[n])
                                      for n in weights})
                    rec.inverses.append(rec.pending[0] if len(
                        rec.pending) == 1 else None)
                rec.index += 1
                return out
            return recording

        def inverse(H, percdamp):
            U = rec.inverse(H, percdamp)
            if U.device.type == "cpu":
                rec.pending.append(U.clone())
            return U

        self.handler = logging.Handler()
        self.handler.emit = lambda r: (torch.cuda.synchronize(),
                                       self.stamps.append(time.perf_counter()))
        self.logger, self.level = get_logger(), get_logger().level
        self.logger.addHandler(self.handler)
        self.logger.setLevel(logging.INFO)
        self.mod._make_quant = make
        self.gptq._inverse_factor = inverse
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.mod._make_quant = self.orig
        self.gptq._inverse_factor = self.inverse
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)

    def layer_seconds(self):
        t = [self.t0] + self.stamps
        return [b - a for a, b in zip(t, t[1:])]


def objective(torch, w, hess, dq) -> float:
    """GPTQ's objective tr((W - W^) H (W - W^)^T), float64."""
    e = (w.double() - dq.double())
    return float(((e @ hess.double()) * e).sum())


def hold_to_rtn(torch, calls, phase: str) -> dict:
    """Each recorded projection quantized against a Hessian: GPTQ's
    objective and RTN's of the same float weight on that Hessian; GPTQ
    must not be worse. {name or "name#i": (gptq, rtn)}."""
    from bitblas_tpu_torch.quantization.gptq import rtn_quantize
    out = {}
    for i, call in enumerate(calls):
        for name, (w, hess, qw) in call.items():
            if hess is None:
                continue
            rtn = rtn_quantize(w, 4, qw.group_size)
            g, r = (objective(torch, w, hess, q.dequantize())
                    for q in (qw, rtn))
            out[f"{name}#{i}"] = {"gptq": g, "rtn": r, "ratio": g / r}
            if not g <= r:
                raise AssertionError(f"{phase} {name}#{i}: GPTQ's objective "
                                     f"{g} exceeds RTN's {r}")
    return out


def _f16_dequant(torch, qw):
    """A QuantizedWeight's [N, K] weight with float16 scales and zeros,
    rounded once to float16: what the kernels decode."""
    g = qw.group_size
    s = qw.scales.half().float().repeat_interleave(g, dim=1)
    z = qw.zeros.half().float().repeat_interleave(g, dim=1)
    return ((qw.codes.float() - z) * s).half()


def check_quant_wiring(torch, layer, name: str, qw) -> dict:
    """One projection's packed buffers decoded by kernel 2 and read back
    through kernel 1 on one-hot rows (the tiled instance at M = 256 over
    every column, the decode instance at M = 16 on a sample): bit-equal to
    the QuantizedWeight with float16 scales."""
    from bitblas_tpu_torch.kernels.dequant_matmul import dequant_matmul_u4
    from bitblas_tpu_torch.kernels.materialize import weight_decode_u4
    want = _f16_dequant(torch, qw)
    qw_, sc, zr = (getattr(layer, f"{name}_{t}")
                   for t in ("qweight", "scales", "zeros"))
    N, K = want.shape
    if not torch.equal(weight_decode_u4(qw_, sc, zr), want):
        raise AssertionError(f"quantize_llama {name}: kernel 2's weight "
                             f"differs from the QuantizedWeight's")
    eye = torch.eye(K, dtype=torch.float16, device="cuda")
    for o in range(0, K, 256):
        if not torch.equal(dequant_matmul_u4(eye[o:o + 256], qw_, sc, zr),
                           want[:, o:o + 256].T):
            raise AssertionError(f"quantize_llama {name}: kernel 1's "
                                 f"one-hot rows {o}.. differ (M = 256)")
    A, ks = _onehot(torch, 16, K, torch.float16)
    if not torch.equal(dequant_matmul_u4(A, qw_, sc, zr), want[:, ks].T):
        raise AssertionError(f"quantize_llama {name}: kernel 1's one-hot "
                             f"rows differ (M = 16)")
    return {"projection": name, "N": N, "K": K, "kernel2": "bit-equal",
            "kernel1_M256_every_column": "bit-equal",
            "kernel1_M16_sample": "bit-equal"}


def _calib_tokens(V: int, seed: int):
    import numpy as np
    return np.random.default_rng(seed).integers(0, V, QUANT_CALIB)


def _packed_bytes(model) -> int:
    return sum(t.numel() * t.element_size()
               for n, t in model.named_buffers()
               if n.endswith(("qweight", "scales", "zeros")))


def quantize_llama(torch):
    """quantize_llama: 32 layers at Llama-2-7B's widths, float16 weights
    drawn on the card, GPTQ uint4 g128 with QUANT_CALIB calibration
    tokens (seconds a layer and in all), the packed bytes, GPTQ's
    objective against RTN's for every projection of QUANT_SAMPLE_LAYERS,
    one projection's wiring through kernels 1 and 2; then RTN of the same
    weights (speculative's draft b). Returns (GPTQ model, head, RTN
    model, RTN head, GPTQ seconds)."""
    from bitblas_tpu_torch.models.quantize_hf import (
        quantize_llama_from_hf_fp16)
    hf = LLAMA2_7B_HF
    state = float_llama_state(torch, hf, seed=71)
    torch.cuda.synchronize()
    calib = _calib_tokens(hf["vocab_size"], 72)
    keep = {4 * li + j for li in QUANT_SAMPLE_LAYERS for j in range(4)}
    torch.cuda.reset_peak_memory_stats()
    with QuantRecorder(keep) as rec:
        model, head = quantize_llama_from_hf_fp16(
            state, hf, method="gptq", calib_tokens=calib, device="cuda")
        torch.cuda.synchronize()
    total_s = time.perf_counter() - rec.t0
    per_layer = rec.layer_seconds()
    packed = _packed_bytes(model)
    if packed != LLAMA_WEIGHT_BYTES:
        raise AssertionError(f"quantize_llama: {packed} packed bytes, "
                             f"serve's {LLAMA_WEIGHT_BYTES}")
    objectives = hold_to_rtn(torch, rec.calls, "quantize_llama")
    wiring = check_quant_wiring(torch, model.layers[0], "q",
                                rec.calls[0]["q"][2])
    peak = torch.cuda.max_memory_allocated()
    rec.calls.clear()
    t0 = time.perf_counter()
    rtn, rtn_head = quantize_llama_from_hf_fp16(state, hf, method="rtn",
                                                device="cuda")
    torch.cuda.synchronize()
    rtn_s = time.perf_counter() - t0
    del state
    torch.cuda.empty_cache()
    emit({"phase": "quantize_llama", "model": "Llama-2-7B widths, float16 "
          "N(0, 0.02) -> GPTQ uint4 g128", "layers": hf["num_hidden_layers"],
          "calib_tokens": list(QUANT_CALIB), "seconds": total_s,
          "seconds_per_layer": per_layer,
          "mean_layer_s": sum(per_layer) / len(per_layer),
          "rtn_seconds": rtn_s, "packed_bytes": packed,
          "peak_mem_gb": peak / 2 ** 30,
          "sample_layers": list(QUANT_SAMPLE_LAYERS),
          "objective_gptq_vs_rtn": objectives,
          "worst_ratio": max(o["ratio"] for o in objectives.values()),
          "wiring": wiring})
    return model, head, rtn, rtn_head, total_s


def _split_rows(call, qw):
    """{name: (codes, scales, zeros)} of a stacked sweep `qw` over the
    rows of a recorded call's projections, in the call's order."""
    out, r0 = {}, 0
    for name, (w, _, _) in call.items():
        rows = slice(r0, r0 + w.shape[0])
        out[name] = (qw.codes[rows], qw.scales[rows], qw.zeros[rows])
        r0 = rows.stop
    return out


def sweep_witness(torch, calls, inverses) -> dict:
    """The card's GPTQ sweep on each recorded CPU call's own weights,
    Hessian and inverse factor U (computed on the CPU; q / k / v and gate /
    up stacked, as the quantizer sweeps them): the codes, scales and zeros
    that differ from the CPU's; then the card's own GPTQ on
    the Hessian rounded to float32, and with U rounded to float32 (a
    planted precision fault): each projection's share of equal codes, the
    largest step, and the layer objective's relative gap from the CPU's
    (on the CPU's Hessians)."""
    from bitblas_tpu_torch.quantization import gptq
    inverse = gptq._inverse_factor
    out = {"same": {}, "f32_hessian": {}, "f32_u": {}}
    obj = {k: 0.0 for k in ("cpu", "f32_hessian", "f32_u")}
    for call, u_cpu in zip(calls, inverses):
        names = list(call)
        h = call[names[0]][1].cuda()
        w = torch.cat([call[n][0] for n in names]).cuda()
        for tag, hh in (("same", h), ("f32_hessian", h.float().double()),
                        ("f32_u", h)):
            if tag == "same":
                # the CPU quantizer's own U: float64 inv and Cholesky
                # differ between LAPACK and cuSOLVER in their last bits,
                # which on some hosts' Hessians flipped a scale's rounding
                # (2 of down's 352,256 scales on one H100 host): the
                # witness holds the sweep
                gptq._inverse_factor = lambda H, p: u_cpu.to(H.device)
            if tag == "f32_u":
                gptq._inverse_factor = lambda H, p: inverse(H, p).float(
                    ).double()
            try:
                qw = gptq.gptq_quantize(w, hh, 4, 128)
            finally:
                gptq._inverse_factor = inverse
            for n, (c, sc, zr) in _split_rows(call, qw).items():
                want = call[n][2]
                d = (c.cpu().long() - want.codes.long()).abs()
                if tag == "same":
                    out[tag][n] = {
                        "codes_differ": int((d != 0).sum()),
                        "scales_differ": int((sc.cpu() != want.scales).sum()),
                        "zeros_differ": int((zr.cpu() != want.zeros).sum())}
                    continue
                out[tag][n] = {"equal_share": (d == 0).float().mean().item(),
                               "max_step": int(d.max())}
                got = gptq.QuantizedWeight(c, sc, zr, 4, 128).dequantize()
                obj[tag] += objective(torch, call[n][0].cuda(), h, got)
                if tag == "f32_hessian":
                    obj["cpu"] += objective(torch, call[n][0].cuda(), h,
                                            want.dequantize().cuda())
        del h, w
    for tag in ("f32_hessian", "f32_u"):
        out[tag]["objective_rel_gap"] = abs(obj[tag] - obj["cpu"]) / obj[
            "cpu"]
    return out


def check_reference_quantize(torch):
    """reference_quantize: one layer at Llama-2-7B's widths quantized on
    the card and on the CPU from the same float16 weights and calibration
    tokens. RTN's packed buffers bit-equal; GPTQ on the card through the
    captured graph bit-equal to the card's eager sweep; the card's sweep on
    the CPU's recorded weights, Hessians and inverse factors bit-equal to
    the CPU's codes, scales and zeros (`sweep_witness`); the layer
    objective (tr(E H E^T)
    over the seven projections, each on its own side's Hessian) within
    QUANT_REF_OBJECTIVE of the CPU's. Reported beside them: each
    projection's share of equal codes card against CPU, the largest
    relative gap between the two sides' Hessians, and the witness's
    readings on float32-rounded Hessians and a float32 U. The row is
    emitted before any check fails."""
    from bitblas_tpu_torch.models.quantize_hf import (
        quantize_llama_from_hf_fp16)
    from bitblas_tpu_torch.quantization import gptq, packing
    t0 = time.perf_counter()
    hf = dict(LLAMA2_7B_HF, num_hidden_layers=1)
    state = float_llama_state(torch, hf, seed=73)
    cpu_state = {k: v.cpu() for k, v in state.items()}
    calib = _calib_tokens(hf["vocab_size"], 74)
    models, objectives, seconds, calls, inverses = {}, {}, {}, {}, {}
    takes = gptq._GraphedSweep.takes
    for method, run, st in (("rtn", "cuda", state), ("rtn", "cpu", cpu_state),
                            ("gptq", "cuda", state),
                            ("gptq", "cuda_eager", state),
                            ("gptq", "cpu", cpu_state)):
        if run == "cuda_eager":
            gptq._GraphedSweep.takes = staticmethod(lambda *a: False)
        ts = time.perf_counter()
        try:
            with QuantRecorder() as rec:
                m, _ = quantize_llama_from_hf_fp16(
                    st, hf, method=method, calib_tokens=calib,
                    device="cpu" if run == "cpu" else "cuda")
        finally:
            gptq._GraphedSweep.takes = takes
        seconds[f"{method}_{run}"] = time.perf_counter() - ts
        models[method, run] = {k: v.cpu() for k, v in m.state_dict().items()}
        if method == "gptq":     # each projection's, on the card, float64
            objectives[run] = {n: objective(torch, w.cuda(), h.cuda(),
                                            q.dequantize().cuda())
                               for call in rec.calls
                               for n, (w, h, q) in call.items()}
            if run != "cuda_eager":
                calls[run] = rec.calls
                inverses[run] = rec.inverses
        del m, rec
    del state
    torch.cuda.empty_cache()
    ts = time.perf_counter()
    if any(u is None for u in inverses["cpu"]):
        raise AssertionError("reference_quantize: a CPU GPTQ call made no "
                             "single inverse factor")
    witness = sweep_witness(torch, calls["cpu"], inverses["cpu"])
    seconds["witness"] = time.perf_counter() - ts
    hess_gap = {}
    for card, cpu in zip(calls["cuda"], calls["cpu"]):
        hc, hp = (next(iter(c.values()))[1].cpu() for c in (card, cpu))
        hess_gap["/".join(cpu)] = ((hc - hp).abs().max()
                                   / hp.abs().max()).item()
    del calls
    torch.cuda.empty_cache()
    failed = []
    card, cpu = models["rtn", "cuda"], models["rtn", "cpu"]
    if any(not torch.equal(card[k], cpu[k]) for k in cpu):
        failed.append("RTN buffers differ card against CPU")
    graphed, eager = models["gptq", "cuda"], models["gptq", "cuda_eager"]
    if any(not torch.equal(graphed[k], eager[k]) for k in eager):
        failed.append("the graphed sweep differs from the eager one")
    if any(v for r in witness["same"].values() for v in r.values()):
        failed.append("the card's sweep on the CPU's Hessians differs from "
                      "the CPU's")
    card, cpu = models["gptq", "cuda"], models["gptq", "cpu"]
    codes = {}
    for k in cpu:
        if k.endswith("qweight"):
            d = (packing.unpack_k(card[k], 4).long()
                 - packing.unpack_k(cpu[k], 4).long()).abs()
            codes[k.split(".")[2].split("_")[0]] = {
                "equal_share": (d == 0).float().mean().item(),
                "one_step": int((d == 1).sum()),
                "more": int((d > 1).sum()), "max_step": int(d.max())}
    total = {r: sum(o.values()) for r, o in objectives.items()}
    gap = abs(total["cuda"] - total["cpu"]) / total["cpu"]
    if gap > QUANT_REF_OBJECTIVE:
        failed.append(f"layer objective {gap} from the CPU's > "
                      f"{QUANT_REF_OBJECTIVE}")
    emit({"phase": "reference_quantize", "layers": 1,
          "rtn_buffers_equal": "RTN buffers differ" not in str(failed),
          "graphed_equals_eager": "graphed" not in str(failed),
          "witness_same_hessian": witness["same"],
          "witness_f32_hessian": witness["f32_hessian"],
          "witness_f32_u": witness["f32_u"],
          "hessian_rel_gap": hess_gap,
          "gptq_codes": codes, "objective": objectives,
          "layer_objective": total, "objective_rel_gap": gap,
          "objective_tol": QUANT_REF_OBJECTIVE, "seconds": seconds,
          "wall_s": time.perf_counter() - t0, "failed": failed})
    if failed:
        raise AssertionError(f"reference_quantize: {failed}")


def check_quantize_mixtral(torch):
    """quantize_mixtral: one layer at Mixtral-8x7B-v0.1's widths, GPTQ
    with routed calibration on the card. Expert ZERO_EXPERT is kept out of
    every top-2: every embedding holds ZERO_CHANNEL_VALUE in channel 0,
    which q / k / v do not read and o does not write, so every token's
    normalized MLP input is positive there; the router's column 0 is 0
    but for that expert's -10, the lowest logit for every token by far.
    It, and any other expert the quantizer's warnings name, must be RTN's
    bit for bit; every expert with traffic not worse than RTN on its own
    Hessian; the quantized layer's output finite."""
    import logging
    import numpy as np
    from bitblas_tpu_torch.common import get_logger
    from bitblas_tpu_torch.models.hf_import import QuantLlamaLM
    from bitblas_tpu_torch.models.quantize_hf import (
        quantize_mixtral_from_hf_fp16)
    from bitblas_tpu_torch.quantization.gptq import rtn_quantize
    hf = dict(MIXTRAL_8X7B_HF, num_hidden_layers=1)
    state = float_llama_state(torch, hf, seed=75, experts=True)
    state["model.embed_tokens.weight"][:, 0] = ZERO_CHANNEL_VALUE
    for p in ("q", "k", "v"):
        state[f"model.layers.0.self_attn.{p}_proj.weight"][:, 0] = 0.0
    state["model.layers.0.self_attn.o_proj.weight"][0] = 0.0
    router = state["model.layers.0.block_sparse_moe.gate.weight"]
    router[:, 0] = 0.0
    router[ZERO_EXPERT, 0] = -10.0
    calib = _calib_tokens(hf["vocab_size"], 76)
    warned = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda r: warned.append(r.getMessage())
    get_logger().addHandler(handler)
    try:
        with QuantRecorder() as rec:
            model, head = quantize_mixtral_from_hf_fp16(
                state, hf, method="gptq", calib_tokens=calib, device="cuda")
            torch.cuda.synchronize()
    finally:
        get_logger().removeHandler(handler)
    seconds = time.perf_counter() - rec.t0
    idle = sorted({int(m.split("expert ")[1].split()[0]) for m in warned})
    if ZERO_EXPERT not in idle or len(warned) != 2 * len(idle):
        raise AssertionError(f"quantize_mixtral: warnings {warned}")
    moe = model.layers[0].moe
    for e in idle:
        for hfn, name in (("w1", "gate"), ("w3", "up"), ("w2", "down")):
            w = state[f"model.layers.0.block_sparse_moe.experts.{e}."
                      f"{hfn}.weight"].float()
            qw = rtn_quantize(w, 4, 128)
            packed = moe.ops[name].transform_weight(
                qw.codes.to(torch.int8), scale=qw.scales.half(),
                zeros=qw.zeros.half())
            if not all(torch.equal(a, b) for a, b in
                       zip(moe.expert(name, e), packed)):
                raise AssertionError(f"quantize_mixtral: expert {e} {name} "
                                     f"(no traffic) is not RTN's")
    experts = [c for c in rec.calls if set(c) <= {"gate", "up", "down"}]
    objectives = hold_to_rtn(torch, experts, "quantize_mixtral")
    toks = np.random.default_rng(77).integers(0, hf["vocab_size"], (1, 64))
    logits = QuantLlamaLM(model, head)(torch.from_numpy(toks))
    if not torch.isfinite(logits).all():
        raise AssertionError("quantize_mixtral: non-finite logits")
    emit({"phase": "quantize_mixtral", "layers": 1, "experts": 8,
          "calib_tokens": list(QUANT_CALIB), "seconds": seconds,
          "zero_traffic_expert": ZERO_EXPERT, "experts_without_traffic":
          idle, "without_traffic": "RTN bit-equal",
          "expert_objectives": objectives,
          "worst_ratio": max(o["ratio"] for o in objectives.values()),
          "logits_absmax": logits.abs().max().item()})
    del model, state
    torch.cuda.empty_cache()


def generate_logits(torch, lm, tokens, S: int):
    """The logits `QuantLlamaLM.generate` decides each new token of
    `tokens` [S + n] by (the prefill's last row, then one decode_step a
    token over the float16 slot cache `_CachedLM` fills as generate does),
    teacher-forced: [n, V] float32 on the CPU."""
    from bitblas_tpu_torch.models.speculative import _CachedLM
    model, head = lm.model, lm.head
    dev = model.device
    n = len(tokens) - S
    hidden, _, _ = model.make_prefill(S)(head.embed_tokens(tokens[:S])[None],
                                         torch.arange(S, device=dev)[None])
    rows = [head.logits(hidden[:, -1:])[0, -1]]
    cache = _CachedLM(lm, list(tokens[:S]), S + n)
    ck, cv = cache.ck, cache.cv
    for i in range(n - 1):
        lengths = torch.tensor([S + i], dtype=torch.int32, device=dev)
        hidden, ck, cv = model.decode_step(
            head.embed_tokens([[int(tokens[S + i])]]), ck, cv, cache.slots,
            lengths)
        rows.append(head.logits(hidden)[0, -1])
    return torch.stack(rows).float().cpu()


def speculative_phase(torch, counters, lm, draft_b, gen_prompt_seed=78):
    """speculative: the 32-layer GPTQ target, draft (a) the target itself,
    draft (b) the RTN model of the same float weights. `generate`'s greedy
    tokens (timed) are the reference, and the logits it decided them by
    (`generate_logits`) give each position's top-2 margin: speculation's
    tokens must equal the reference up to the first difference, which
    must fall where the margin is under SPEC_FLIP_MARGIN (as must every
    proposal draft (a) loses), with at least SPEC_MIN_DECIDED tokens above
    the limit compared. The card's reading: the change of that top-2 gap
    between `generate`'s logits and decode_chunk's at M = gamma + 1 (the
    verify's path), under the limit. Cached speculation at gamma =
    SPEC_GAMMA (timed): draft (a) over SPEC_NEW tokens, draft (b) over
    SPEC_NEW_RTN; uncached with draft (a) over SPEC_NEW_UNCACHED; a
    sampled run (draft a) twice. The row is emitted before any check
    fails. Returns the launch counts of the whole phase."""
    import numpy as np
    from bitblas_tpu_torch.models import speculative as spec
    V = lm.model.cfg.vocab_size
    prompt = np.random.default_rng(gen_prompt_seed).integers(
        0, V, SPEC_PROMPT).astype(np.int32)
    u4 = next(c for c in counters if c.__name__ == "dequant_matmul_u4")
    for c in counters:
        c.launches = 0
    u4.decode_launches = u4.tiled_launches = 0
    failed = []

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    S = SPEC_PROMPT
    ref, gen_s = timed(lambda: lm.generate(prompt, SPEC_NEW))
    logits = generate_logits(torch, lm, ref, S)
    top = logits.topk(2, dim=-1)
    if not torch.equal(top.indices[:, 0], torch.from_numpy(ref[S:]).long()):
        failed.append("generate_logits' argmax is not generate's stream")
    margin = top.values[:, 0] - top.values[:, 1]
    # decode_chunk over the reference, gamma + 1 tokens a call as a verify
    cached = spec._CachedLM(lm, list(ref[:S]), S + SPEC_NEW)
    rows = []
    for p0 in range(S - 1, S + SPEC_NEW - 1, SPEC_GAMMA + 1):
        seq = list(ref[:min(p0 + SPEC_GAMMA + 1, S + SPEC_NEW - 1)])
        rows.append(cached.logits_after(seq, len(seq) - p0))
    del cached
    chunk = torch.from_numpy(np.concatenate(rows))
    a, b = top.indices[:, :1], top.indices[:, 1:]
    reading = ((chunk.gather(1, a) - chunk.gather(1, b))
               - (logits.gather(1, a) - logits.gather(1, b))).abs().max()
    reading = reading.item()
    if not reading < SPEC_FLIP_MARGIN:
        failed.append(f"the card's top-2 gap change {reading} is not under "
                      f"{SPEC_FLIP_MARGIN}")

    def held(tag, out, new):
        """out's new tokens against generate's: equal up to the first
        difference, which must fall where the margin is under the limit;
        the number of tokens compared before it whose margin exceeds the
        limit."""
        diff = np.flatnonzero(out[S:S + new] != ref[S:S + new])
        first = int(diff[0]) if diff.size else new
        if first < new and margin[first] > SPEC_FLIP_MARGIN:
            failed.append(f"{tag}: token {first} differs from generate's at "
                          f"a margin of {margin[first].item()}")
        return first, int((margin[:first] > SPEC_FLIP_MARGIN).sum())

    runs = {}
    for tag, draft, new in (("a_self", lm, SPEC_NEW),
                            ("b_rtn", draft_b, SPEC_NEW_RTN),
                            ("uncached_a_self", lm, SPEC_NEW_UNCACHED)):
        fn = (spec.speculative_generate if tag.startswith("uncached")
              else spec.speculative_generate_cached)
        (out, st), sec = timed(lambda: fn(lm, draft, prompt, new,
                                          gamma=SPEC_GAMMA,
                                          return_stats=True))
        first, decided = held(tag, out, new)
        # where draft (a), the target itself, lost a proposal: the margin
        # there must be under the limit too
        done, rejected = 0, []
        for r in st.rounds if draft is lm else ():
            if r < min(SPEC_GAMMA + 1, new - done):
                rejected.append(done + r - 1)
            done += r
        if any(margin[i] > SPEC_FLIP_MARGIN for i in rejected):
            failed.append(f"{tag}: the target rejected its own proposal "
                          f"where the margin exceeds the limit: {rejected}")
        runs[tag] = {"tokens_s": new / sec, "seconds": sec,
                     "new_tokens": new,
                     "acceptance_rate": st.acceptance_rate,
                     "target_calls": st.target_calls,
                     "draft_calls": st.draft_calls, "rounds": st.rounds,
                     "first_difference": first, "decided_compared": decided,
                     "rejected_at": rejected}
    if runs["a_self"]["decided_compared"] < SPEC_MIN_DECIDED:
        failed.append(f"{runs['a_self']['decided_compared']} decided tokens "
                      f"compared < {SPEC_MIN_DECIDED}")
    sampled = [spec.speculative_generate_cached(
        lm, lm, prompt, 32, gamma=SPEC_GAMMA, temperature=0.8, seed=11)
        for _ in range(2)]
    if not np.array_equal(*sampled):
        failed.append("a seeded sampled run did not repeat")
    launches = {c.__name__: c.launches for c in counters}
    launches[DECODE["uint4"]] = u4.decode_launches
    launches[TILED["uint4"]] = u4.tiled_launches
    for k in ("flash_attention_fwd", "flash_decode", DECODE["uint4"]):
        if launches[k] <= 0:
            failed.append(f"{k} was not launched")
    emit({"phase": "speculative", "prompt": S, "new_tokens": SPEC_NEW,
          "gamma": SPEC_GAMMA, "generate_tokens_s": SPEC_NEW / gen_s,
          "generate_seconds": gen_s, "flip_margin": SPEC_FLIP_MARGIN,
          "top2_gap_reading": reading,
          "max_logit_gap": (chunk - logits).abs().max().item(),
          "logits_absmax": logits.abs().max().item(),
          "margins": [round(m, 4) for m in margin.tolist()],
          **runs, "sampled_repeated": bool(np.array_equal(*sampled)),
          "launches": launches, "failed": failed})
    if failed:
        raise AssertionError(f"speculative: {failed}")
    return launches


def check_bitnet_train(torch):
    """bitnet_train: bitlinear_train_forward at N x K = 14336 x 4096, 256
    rows, forward and backward on the card (autograd through the STE)
    against the CPU's float64 truth on the card's fake-quantized operands:
    the output and both gradients within 1e-5 of their largest value; the
    card's fake-quantized weight against the CPU's."""
    from bitblas_tpu_torch.models.bitnet import (activation_quant,
                                                 bitlinear_train_forward,
                                                 weight_quant)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(79)
    M, N, K = 256, 14336, 4096
    x = torch.randn((M, K), generator=gen, device="cuda").requires_grad_()
    w = torch.randn((N, K), generator=gen, device="cuda").requires_grad_()
    out = bitlinear_train_forward(x, w)
    (out ** 2).sum().backward()
    xq = activation_quant(x.detach()).cpu().double()
    wq = weight_quant(w.detach()).cpu().double()
    o64 = xq @ wq.T
    go = 2.0 * o64
    truth = {"out": o64, "grad_w": go.T @ xq, "grad_x": go @ wq}
    got = {"out": out.detach(), "grad_w": w.grad, "grad_x": x.grad}
    errs = {}
    for k, t in truth.items():
        errs[k] = ((got[k].cpu().double() - t).abs().max()
                   / t.abs().max()).item()
        if not errs[k] <= 1e-5:
            raise AssertionError(f"bitnet_train {k}: {errs[k]} of the "
                                 f"largest > 1e-5")
    wq_gap = (weight_quant(w.detach().cpu()).double() - wq).abs().max()

    def step():
        w.grad = x.grad = None
        (bitlinear_train_forward(x, w) ** 2).sum().backward()

    emit({"phase": "bitnet_train", "M": M, "N": N, "K": K,
          "rel_err": errs, "tol": 1e-5,
          "weight_quant_card_vs_cpu_max": wq_gap.item(),
          "fwd_bwd_ms": time_ms(torch, step, 10, flush=False)})


def model_tools_phases(torch, counters):
    """The model tools' phases (`--quantize`, and the full run): returns
    (the launches of serve_quantized and speculative, {phase: seconds})."""
    import numpy as np
    laps, t = {}, time.perf_counter()
    model, head, rtn, rtn_head, quant_s = quantize_llama(torch)
    laps["quantize_llama"] = time.perf_counter() - t
    rng = np.random.default_rng(0)
    V = model.cfg.vocab_size
    ctx = {"cfg": model.cfg, "model": model, "head": head,
           "prompts": [rng.integers(0, V, n).astype(np.int32)
                       for n in (200, 300, 450, 500)],
           "pair": [], "init_s": quant_s, "weight_bytes": _packed_bytes(model),
           "name": "Llama-2-7B widths, GPTQ uint4 g128 quantized on the card"}
    t = time.perf_counter()
    routes = RouteRecorder()
    with routes:
        row = serve(torch, ctx, counters, *QUANT_PHASE, routes=routes)
    launches = dict(row["launches"])
    laps["serve_quantized"] = time.perf_counter() - t
    t = time.perf_counter()
    from bitblas_tpu_torch.models.hf_import import QuantLlamaLM
    spec = speculative_phase(torch, counters, QuantLlamaLM(model, head),
                             QuantLlamaLM(rtn, rtn_head))
    for k, n in spec.items():
        launches[k] = launches.get(k, 0) + n
    laps["speculative"] = time.perf_counter() - t
    del ctx, model, head, rtn, rtn_head
    torch.cuda.empty_cache()
    t = time.perf_counter()
    check_quantize_mixtral(torch)
    laps["quantize_mixtral"] = time.perf_counter() - t
    t = time.perf_counter()
    check_reference_quantize(torch)
    laps["reference_quantize"] = time.perf_counter() - t
    t = time.perf_counter()
    check_bitnet_train(torch)
    laps["bitnet_train"] = time.perf_counter() - t
    return launches, laps


# the GPTQ model quantized on the card, served as `serve`
QUANT_PHASE = ("serve_quantized", "token", {}, LLAMA + ("flash_decode",))


# -- the formats phase: kernels 1 and 2 for every other weight format with
# float16 / bfloat16 activations, through module.Linear and QuantLinear --

FORMAT_SHAPES = ((11008, 4096), (4096, 11008))   # Llama-2-7B MLP (N, K)
FORMAT_MS = (4, 256, 2048)   # decode instance, tiled instance, materialize
FORMAT_GROUP = 128
# The materialize plan's product is cuBLAS's, whose sums over K = 11008
# stray past one ulp of the output (1.2 f16 ulps, 1.15 bf16 ulps at the
# formats phase's shapes): it is held, against the fused kernels and the
# float32 plain version, to the route table's 4e-3 of the largest output
# in float16 (four units of 2^-10), and to four units of bfloat16's 2^-7
# in bfloat16.
ROUTE_TOL = {"float16": 4e-3, "bfloat16": 4 * 2.0 ** -7}


def _route_tol(out, ref) -> float:
    """ROUTE_TOL of out's type times the largest |ref|."""
    return (ROUTE_TOL[str(out.dtype).split(".")[-1]]
            * ref.float().abs().max().item())


def _format_weights(torch, gen, w_dtype, a_dtype, N, K):
    """Reference-layout operands drawn on the card: codes [N, K] (every
    code, e5m2's inf / NaN codes made finite), scales [N, K/g] in A's
    type, zeros [N, K/g] (uint only)."""
    from bitblas_tpu_torch.quantization.formats import source_format_and_bits
    family, bits = source_format_and_bits(w_dtype)
    codes = torch.randint(0, 1 << bits, (N, K), generator=gen,
                          device="cuda", dtype=torch.int64)
    if family == "fp_e5m2":
        codes = torch.where((codes & 0x7C) == 0x7C, codes & 0xBF, codes)
    if family == "int" and bits == 8:
        codes = codes.to(torch.uint8).view(torch.int8)
    elif family == "int":
        codes = codes - (1 << (bits - 1))      # values, as a user has them
    adt = getattr(torch, a_dtype)
    G = K // FORMAT_GROUP
    sc = (torch.rand((N, G), generator=gen, device="cuda") * 0.01
          + 0.005).to(adt)
    zr = (torch.randint(0, 1 << bits, (N, G), generator=gen, device="cuda")
          .to(adt) if family == "uint" else None)
    return codes, sc, zr


def _format_layers(torch, gen):
    """One module.Linear per new (A, W) pair and Llama-2-7B MLP shape,
    built on the card (untuned: M <= 16 the decode instance, up to 511 the
    tiled one, from 512 the materialize plan), scaled in groups of 128,
    uint with zeros (original), output in A's type; and QuantLinear(bits=1
    / 2) at 4096 -> 11008 from pack() of a fake-quantized float weight."""
    from bitblas_tpu_torch.integration.pytorch import QuantLinear
    from bitblas_tpu_torch.module import Linear
    from bitblas_tpu_torch.ops.matmul_config import FLOAT_PAIRS
    layers = []
    for a_dtype, w_dtype in FLOAT_PAIRS:
        for N, K in FORMAT_SHAPES:
            codes, sc, zr = _format_weights(torch, gen, w_dtype, a_dtype, N,
                                            K)
            lin = Linear(K, N, A_dtype=a_dtype, W_dtype=w_dtype,
                         out_dtype=a_dtype, group_size=FORMAT_GROUP,
                         with_scaling=True, with_zeros=zr is not None,
                         zeros_mode="original" if zr is not None else None,
                         opt_M=list(FORMAT_MS), enable_tuning=False,
                         device="cuda")
            lin.load_and_transform_weight(codes, scales=sc, zeros=zr)
            layers.append((a_dtype, w_dtype, N, K, lin))
    quant = []
    for bits in (1, 2):
        N, K, g = 11008, 4096, FORMAT_GROUP
        s = torch.rand((N, K // g), generator=gen, device="cuda") * 0.02 \
            + 0.01
        z = torch.randint(0, 1 << bits, (N, K // g), generator=gen,
                          device="cuda").float()
        q = torch.randint(0, 1 << bits, (N, K), generator=gen,
                          device="cuda").float()
        gi = torch.arange(K, device="cuda") // g
        fake = torch.nn.Linear(K, N, bias=True, device="cuda")
        fake.weight.data = (q - z[:, gi]) * s[:, gi]
        fake.bias.data = torch.randn(N, generator=gen, device="cuda") * 0.1
        ql = QuantLinear(bits, g, K, N, bias=True, device="cuda")
        ql.pack(fake, s, z)
        quant.append((bits, ql))
    return layers, quant


def _onehot(torch, M, K, dtype):
    """M one-hot rows: out[m, n] = W[n, k_m] exactly."""
    ks = torch.arange(M, device="cuda") * (K // M) + 5
    A = torch.zeros((M, K), device="cuda", dtype=dtype)
    A[torch.arange(M, device="cuda"), ks] = 1
    return A, ks


def check_formats(torch, flush, floor_ms):
    """The formats phase. First the main path alone: every launch counter
    of dequant_matmul_fmt and weight_decode_fmt set to 0, each Linear
    forward at M = 4 / 256 / 2048 and each QuantLinear at M = 4 / 256, the
    counters read, and each format's decode instance, tiled instance and
    kernel 2 must have launched. Then, outside that count, each output
    against its plain version on the card (one ulp of the output type of
    each output, `out_ulps`: M = 4 against the split plain version, 256 the
    single-pass one; the materialize plan at M = 2048 bit-equal to the
    library product of the plain decoded weight, and within one ulp or the
    route table's 4e-3 of the largest output of the float32 plain
    version: cuBLAS's sums over K = 11008 stray past one ulp), a second call
    bit-equal, kernel 2's decoded weight bit-equal to the plain version's,
    kernel 1's decoded weight read back through one-hot activations on
    both instances bit-equal;
    kernel 2 on every code of each format, unscaled; the timed rows (M =
    4: the decode instance, M = 256: the tiled instance, kernel 2) with
    their bound (bytes N K bits / 8 + 2 N K / g a scale or zero tensor +
    A + out over 3.35 TB/s, operations 2 M N K over 989 TFLOP/s), the
    plain version, the library call (torch.matmul on the decoded weight,
    which the port never calls), stream_ms and the timer floor; and the
    route table (the fused default tile against the materialize plan at M
    = 256 / 512 / 2048, N = 11008, K = 4096)."""
    from bitblas_tpu_torch.kernels import dequant_matmul as dq
    from bitblas_tpu_torch.kernels import materialize as mz
    from bitblas_tpu_torch.testing import out_ulps
    fmt_k, wd = dq.dequant_matmul_fmt, mz.weight_decode_fmt
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    t0 = time.perf_counter()
    layers, quant = _format_layers(torch, gen)
    inputs = {(K, M, a): torch.randn((M, K), generator=gen, device="cuda")
              .to(getattr(torch, a))
              for K in {K for *_, K, _ in layers} for M in FORMAT_MS
              for a in ("float16", "bfloat16")}
    build_s = time.perf_counter() - t0

    # the main path, counted
    torch.cuda.synchronize()
    for c in (fmt_k, wd):
        c.launches = 0
        c.format_launches.clear()
    fmt_k.decode_launches = fmt_k.tiled_launches = 0
    fmt_k.variant_launches.clear()
    outs = {}
    for a_dtype, w_dtype, N, K, lin in layers:
        for M in FORMAT_MS:
            outs[(w_dtype, a_dtype, N, M)] = lin(inputs[(K, M, a_dtype)])
    qouts = {(bits, M): ql(inputs[(ql.in_features, M, "float16")])
             for bits, ql in quant for M in (4, 256)}
    torch.cuda.synchronize()
    launches = {}
    for key, n in fmt_k.variant_launches.items():
        fmt, kind = key.split()[:2]
        launches[f"dequant_matmul_fmt {kind} {fmt}"] = \
            launches.get(f"dequant_matmul_fmt {kind} {fmt}", 0) + n
    for fmt, n in wd.format_launches.items():
        launches[f"weight_decode_fmt {fmt}"] = n
    want = {f"{k} {dq.fused_format(w, a)}"
            for a, w in {(a, w) for a, w, *_ in layers}
            for k in ("dequant_matmul_fmt decode", "dequant_matmul_fmt tiled",
                      "weight_decode_fmt")}
    missing = sorted(k for k in want if launches.get(k, 0) <= 0)
    if missing:
        raise AssertionError(f"formats: not launched: {missing}")
    emit({"phase": "formats_main_path", "layers": len(layers),
          "quant_linears": len(quant), "build_s": build_s,
          "launches": launches, "decode_launches": fmt_k.decode_launches,
          "tiled_launches": fmt_k.tiled_launches})

    rows = []
    for a_dtype, w_dtype, N, K, lin in layers:
        adt = getattr(torch, a_dtype)
        fmt = dq.fused_format(w_dtype, a_dtype)
        bits = lin.bits
        qw, sc, zr = lin.qweight, lin.scales, lin.zeros
        g = FORMAT_GROUP
        Wd = mz.weight_decode_fmt_plain(qw, w_dtype, a_dtype, sc, zr, g)
        dec = wd(qw, w_dtype, a_dtype, sc, zr, g)
        torch.cuda.synchronize()
        if not torch.equal(dec.view(torch.int16), Wd.view(torch.int16)):
            raise AssertionError(f"{fmt} N={N} K={K}: kernel 2's weight "
                                 f"differs from the plain version's")
        for M, tile in ((16, dq.FUSED_TILES[fmt][0]),
                        (64, dq.FMT_TILED_TILE)):
            A1, ks = _onehot(torch, M, K, adt)
            got = fmt_k(A1, qw, w_dtype, sc, zr, g, tile=tile,
                        out_dtype=torch.float32)
            if not torch.equal(got, Wd[:, ks].T.float()):
                raise AssertionError(f"{fmt} N={N} K={K}: kernel 1's "
                                     f"decoded weight (M={M}) differs")
        wbytes = N * K * bits / 8 + 2 * (K // g) * N * (2 if zr is not None
                                                        else 1)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for M in FORMAT_MS:
            A = inputs[(K, M, a_dtype)]
            out = outs[(w_dtype, a_dtype, N, M)]
            again = lin(A)
            route = lin.bitblas_matmul.hint_for(M).decode_mode
            if M <= 16:
                ref = dq.dequant_matmul_fmt_split_plain(
                    A, qw, w_dtype, sc, zr, g, sms=sms)
            else:
                ref = dq.dequant_matmul_fmt_plain(A, qw, w_dtype, sc, zr, g)
            # the materialize plan's product is cuBLAS's: its plain version
            # is the same library product of the plain decoded weight
            lib = torch.matmul(A, Wd.T) if route == "materialize" else None
            torch.cuda.synchronize()
            ulps = out_ulps(out, ref)
            err = (out.float() - ref.float()).abs().max().item()
            tol = _route_tol(out, ref)
            ok = (torch.equal(out, lib) and (ulps <= 1 or err <= tol)) \
                if lib is not None else ulps <= 1
            if not (torch.equal(out, again) and ok):
                raise AssertionError(
                    f"{fmt} M={M} N={N} K={K} ({route}): {ulps} ulps and "
                    f"{err} (tol {tol}) from the plain version, the library "
                    f"product equal: {lib is None or torch.equal(out, lib)}, "
                    f"two calls equal: {torch.equal(out, again)}")
            row = {"phase": "formats", "format": fmt, "M": M, "N": N,
                   "K": K, "group": g, "zeros": zr is not None,
                   "route": route, "ulps": ulps, "max_abs_err": err}
            if route == "materialize":
                row.update({"tol": tol, "equals_library_product": True})
                emit(row)
                rows.append(row)
                continue
            tile = dq.default_tile(fmt, M)
            nbytes = M * K * 2 + wbytes + M * N * 2
            b_ms, b_by = bound(nbytes, 2.0 * M * N * K)
            row.update({
                "kernel": "decode" if M <= 16 else "tiled",
                "tile": list(tile),
                "kernel_ms": time_ms(torch, lambda: fmt_k(
                    A, qw, w_dtype, sc, zr, g, tile=tile), 20, flush),
                "plain_ms": time_ms(torch, lambda: dq.dequant_matmul_fmt_plain(
                    A, qw, w_dtype, sc, zr, g), 3, flush),
                "library_ms": time_ms(torch, lambda: torch.matmul(A, Wd.T),
                                      20, flush),
                "stream_ms": time_ms(torch, _stream(torch, nbytes), 20,
                                     flush),
                "bound_ms": b_ms, "bound_by": b_by,
                "timer_floor_ms": floor_ms})
            emit(row)
            rows.append(row)
        nbytes = wbytes + N * K * 2
        b_ms, b_by = bound(nbytes, 0.0)
        row = {"phase": "formats", "format": fmt, "kernel": "weight_decode",
               "N": N, "K": K, "group": g, "max_abs_err": 0.0,
               "kernel_ms": time_ms(torch, lambda: wd(
                   qw, w_dtype, a_dtype, sc, zr, g), 20, flush),
               "plain_ms": time_ms(torch, lambda: mz.weight_decode_fmt_plain(
                   qw, w_dtype, a_dtype, sc, zr, g), 3, flush),
               "library_ms": None,
               "stream_ms": time_ms(torch, _stream(torch, nbytes), 20, flush),
               "bound_ms": b_ms, "bound_by": b_by, "timer_floor_ms": floor_ms}
        emit(row)
        rows.append(row)
        del Wd, dec
    # QuantLinear(bits=1 / 2) against its plain version
    for bits, ql in quant:
        inner = ql.inner
        for M in (4, 256):
            A = inputs[(ql.in_features, M, "float16")]
            out = qouts[(bits, M)]
            fn = (dq.dequant_matmul_fmt_split_plain if M <= 16
                  else dq.dequant_matmul_fmt_plain)
            kw = dict(sms=torch.cuda.get_device_properties(
                0).multi_processor_count) if M <= 16 else {}
            ref = fn(A, inner.qweight, f"uint{bits}", inner.scales,
                     inner.zeros, ql.group_size, inner.bias, **kw)
            torch.cuda.synchronize()
            ulps = out_ulps(out, ref)
            if not (ulps <= 1 and torch.equal(out, ql(A))):
                raise AssertionError(f"QuantLinear(bits={bits}) M={M}: "
                                     f"{ulps} ulps")
            emit({"phase": "formats", "quant_linear_bits": bits, "M": M,
                  "N": ql.out_features, "K": ql.in_features, "ulps": ulps})
    del layers, quant, outs, qouts
    torch.cuda.empty_cache()

    # kernel 2 on every code of each format, unscaled
    from bitblas_tpu_torch.ops.matmul_config import FLOAT_PAIRS
    from bitblas_tpu_torch.quantization import packing
    from bitblas_tpu_torch.quantization.formats import source_format_and_bits
    codes_ok = []
    for a_dtype, w_dtype in FLOAT_PAIRS:
        bits = source_format_and_bits(w_dtype)[1]
        codes = (torch.arange(64, device="cuda")[:, None] * 3
                 + torch.arange(512, device="cuda")[None, :]) % (1 << bits)
        qw = packing.pack_k(codes, bits)
        got = wd(qw, w_dtype, a_dtype)
        ref = mz.weight_decode_fmt_plain(qw, w_dtype, a_dtype)
        torch.cuda.synchronize()
        nan = torch.isnan(ref)
        if not (torch.equal(torch.isnan(got), nan) and torch.equal(
                got.view(torch.int16)[~nan], ref.view(torch.int16)[~nan])):
            raise AssertionError(f"{w_dtype} -> {a_dtype}: kernel 2 on every "
                                 f"code differs from the plain decode")
        codes_ok.append(dq.fused_format(w_dtype, a_dtype))
    emit({"phase": "formats_every_code", "formats": codes_ok,
          "codes": {f: 1 << source_format_and_bits(dq.split_format(f)[0])[1]
                    for f in codes_ok}})

    # the route table of each format at N = 11008, K = 4096
    from bitblas_tpu_torch.kernels.spec import KernelSpec
    for a_dtype, w_dtype in FLOAT_PAIRS:
        N, K = FORMAT_SHAPES[0]
        adt = getattr(torch, a_dtype)
        fmt = dq.fused_format(w_dtype, a_dtype)
        family, bits = source_format_and_bits(w_dtype)
        qw = _words(torch, gen, (N, K * bits // 32))
        if family == "fp_e5m2":
            b = qw.view(torch.uint8)
            b[(b & 0x7C) == 0x7C] &= 0xBF
        sc = (torch.rand((K // FORMAT_GROUP, N), generator=gen, device="cuda")
              * 0.01 + 0.005).to(adt)
        spec = KernelSpec(m=512, n=N, k=K, a_dtype=a_dtype,
                          out_dtype=a_dtype, family=family, bits=bits,
                          group_size=FORMAT_GROUP, with_scaling=True)
        for M in (256, 512, 2048):
            A = torch.randn((M, K), generator=gen, device="cuda").to(adt)
            tile = dq.default_tile(fmt, M)
            a = fmt_k(A, qw, w_dtype, sc, None, FORMAT_GROUP, tile=tile)
            b = mz.materialize_matmul(spec, A, qw, sc)
            torch.cuda.synchronize()
            ulps = out_ulps(a, b)
            err = (a.float() - b.float()).abs().max().item()
            tol = _route_tol(a, a)
            row = {"phase": "route", "format": fmt, "M": M, "N": N, "K": K,
                   "ulps": ulps, "max_abs_err": err, "tol": tol,
                   "fused_tile": list(tile),
                   "fused_ms": time_ms(torch, lambda: fmt_k(
                       A, qw, w_dtype, sc, None, FORMAT_GROUP, tile=tile),
                       20, flush),
                   "materialize_ms": time_ms(
                       torch, lambda: mz.materialize_matmul(spec, A, qw, sc),
                       20, flush)}
            row["faster"] = ("materialize" if row["materialize_ms"]
                             < row["fused_ms"] else "fused")
            if not (ulps <= 1 or err <= tol):
                raise AssertionError(f"route {fmt} M={M}: the two routes "
                                     f"{ulps} ulps, {err} apart (tol {tol})")
            emit(row)
        del qw, sc
    return rows, launches


# The int_formats phase: int8 activations with each uint / int weight of
# ops/matmul_config.INT_PAIRS, uint at Llama-2-7B's MLP (N, K) and int at
# Llama-3-8B's W2A8 up projection (BitNet's widths), and QuantLinear's
# int8 layers at 4096 -> 11008.
INT_SHAPES = {"uint": (11008, 4096), "int": (14336, 4096)}


def _int_truth(torch, A, qw, w_dtype, sc, zr, g, mode, bias):
    """The float64 sums of A and the weight (v - z) s (rescale v s - z)
    (the integer column's plain version contracts a float32 weight)."""
    from bitblas_tpu_torch.kernels import dequant_matmul as dq
    K = A.shape[1]
    v = dq.decode_int_hopper(qw, w_dtype, torch.float64)
    s = sc.T.double().repeat_interleave(g, dim=1)[:, :K]
    W = v * s
    if zr is not None:
        z = zr.T.double().repeat_interleave(g, dim=1)[:, :K]
        W = W - z if mode == "rescale" else (v - z) * s
    del v, s
    out = A.double() @ W.T
    return out if bias is None else out + bias.double().reshape(1, -1)


def _int_close(torch, out, ref, truth) -> dict:
    """The integer column's tolerance of a scaled output against its plain
    version: int8 within 1 after saturation; a float output within one
    ulp of the float32 plain version, or nearer the float64 truth than it
    is. Returns the readings, with "ok"."""
    from bitblas_tpu_torch.testing import out_ulps
    if out.dtype == torch.int8:
        d = (out.int() - ref.int()).abs().max().item()
        return {"ok": d <= 1, "int8_diff": d}
    ulps = out_ulps(out, ref)
    e_out = (out.double() - truth).abs().max().item()
    e_ref = (ref.double() - truth).abs().max().item()
    return {"ok": ulps <= 1 or e_out <= e_ref, "ulps": ulps,
            "err_vs_f64": e_out, "plain_err_vs_f64": e_ref}


def _int_layers(torch, gen):
    """The int_formats phase's layers, built on the card (untuned: M <= 16
    the decode instance, up to 511 the tiled one, from 512 materialize
    where allowed) from reference-layout operands drawn from a seed: for
    each INT_PAIRS weight three module.Linear(A_dtype="int8") layers,
    unscaled (int32 out), per channel (uint float16 out, int float32 out)
    and g = 128 with a bias (uint also zeros, original mode; saturating
    int8 out); QuantLinear(bits, A_dtype="int8") at 4096 -> 11008, g =
    128, from pack(); and uint4 x float16's layers beyond GPTQ's options
    (unscaled, scales without zeros, zeros with float32 out)."""
    from bitblas_tpu_torch.integration.pytorch import QuantLinear
    from bitblas_tpu_torch.module import Linear
    from bitblas_tpu_torch.ops.matmul_config import INT_PAIRS
    from bitblas_tpu_torch.quantization.formats import source_format_and_bits
    g = FORMAT_GROUP
    layers = []
    for _, w_dtype in INT_PAIRS:
        family, bits = source_format_and_bits(w_dtype)
        N, K = INT_SHAPES[family]
        lo = -(1 << (bits - 1)) if family == "int" else 0
        codes = torch.randint(lo, lo + (1 << bits), (N, K), generator=gen,
                              device="cuda", dtype=torch.int8)
        for kind in ("unscaled", "per_channel", "g128"):
            G = K // g if kind == "g128" else 1
            sc = (torch.rand((N, G), generator=gen, device="cuda") * 0.01
                  + 0.005).half() if kind != "unscaled" else None
            zr = (torch.randint(0, 1 << bits, (N, G), generator=gen,
                                device="cuda").half()
                  if kind == "g128" and family == "uint" else None)
            bias = (torch.randn(N, generator=gen, device="cuda") * 4
                    if kind == "g128" else None)
            out = {"unscaled": "int32", "g128": "int8"}.get(
                kind, "float16" if family == "uint" else "float32")
            lin = Linear(K, N, bias=bias is not None, A_dtype="int8",
                         W_dtype=w_dtype, out_dtype=out,
                         group_size=g if kind == "g128" else -1,
                         with_scaling=sc is not None,
                         with_zeros=zr is not None,
                         zeros_mode="original" if zr is not None else None,
                         opt_M=list(FORMAT_MS), enable_tuning=False,
                         device="cuda")
            lin.load_and_transform_weight(codes, scales=sc, zeros=zr,
                                          bias=bias)
            layers.append((w_dtype, kind, N, K, lin))
        del codes
    quant = []
    for bits in (1, 2, 4):
        N, K = INT_SHAPES["uint"]   # 4096 -> 11008
        s = torch.rand((N, K // g), generator=gen, device="cuda") * 0.02 \
            + 0.01
        z = torch.randint(0, 1 << bits, (N, K // g), generator=gen,
                          device="cuda").float()
        q = torch.randint(0, 1 << bits, (N, K), generator=gen,
                          device="cuda").float()
        gi = torch.arange(K, device="cuda") // g
        fake = torch.nn.Linear(K, N, bias=True, device="cuda")
        fake.weight.data = (q - z[:, gi]) * s[:, gi]
        fake.bias.data = torch.randn(N, generator=gen, device="cuda")
        ql = QuantLinear(bits, g, K, N, bias=True, A_dtype="int8",
                         device="cuda")
        ql.pack(fake, s, z)
        quant.append((bits, ql))
    u4f16 = []
    N, K = INT_SHAPES["uint"]
    codes = torch.randint(0, 16, (N, K), generator=gen, device="cuda",
                          dtype=torch.int8)
    for kind, out, scaled, zeros in (("unscaled", "float16", False, False),
                                     ("scales", "float16", True, False),
                                     ("zeros_f32", "float32", True, True)):
        sc = (torch.rand((N, K // g), generator=gen, device="cuda") * 0.01
              + 0.005).half() if scaled else None
        zr = torch.randint(0, 16, (N, K // g), generator=gen,
                           device="cuda").half() if zeros else None
        lin = Linear(K, N, A_dtype="float16", W_dtype="uint4", out_dtype=out,
                     group_size=g if scaled else -1, with_scaling=scaled,
                     with_zeros=zeros,
                     zeros_mode="original" if zeros else None,
                     opt_M=list(FORMAT_MS), enable_tuning=False,
                     device="cuda")
        lin.load_and_transform_weight(codes, scales=sc, zeros=zr)
        u4f16.append((kind, N, K, lin))
    return layers, quant, u4f16


def check_int_formats(torch, flush, floor_ms):
    """The int_formats phase. First the main path alone: the launch
    counters of dequant_matmul_int, weight_decode_int8 (by format),
    dequant_matmul_fmt and weight_decode_fmt set to 0, each integer-column
    Linear forward at M = 4 / 256 / 2048, each QuantLinear(A_dtype="int8")
    and each of uint4 x float16's other Linears at M = 4 / 256 / 2048,
    the counters read: every format's decode and tiled instances, kernel 3
    at 1 bit, and uint4 x float16's decode and tiled instances and kernel 2
    must have launched. Then, outside that count, each output against its
    plain version on the card: the decode instance bit-equal to its split
    plain version; unscaled outputs (int32) bit-equal to the plain
    version on every route; scaled ones `_int_close` (int8 within 1, float
    within one ulp or nearer the float64 truth); uint4 x float16 within
    one ulp (the materialize plan one ulp or ROUTE_TOL); two calls
    bit-equal; kernel 3 on every code of the six formats bit-equal; the
    timed rows (M = 4: the decode instance, M = 256: the tiled one, on the
    g = 128 layer; kernel 3 at 1 bit; uint4 x float16's instances and
    kernel 2 on its scales-only layer) with bound (bytes A + N K b / 8 + 2
    N K / g a scale or zero tensor + bias + out over 3.35 TB/s, operations
    2 M N K over 1979 TOP/s int8 or 989 TFLOP/s f16), stream_ms, the plain
    version and the library call (torch._int_mm on the pre-decoded int8
    codes, A padded to 17 rows as dense_product pads it: for the scaled
    rows it leaves out the scales, less work than the kernel does;
    torch.matmul on the decoded weight for uint4 x float16), and the route
    table of each per-channel layer (fused against materialize at M = 256
    / 512 / 2048)."""
    from bitblas_tpu_torch.kernels import dequant_matmul as dq
    from bitblas_tpu_torch.kernels import materialize as mz
    from bitblas_tpu_torch.kernels.spec import KernelSpec
    from bitblas_tpu_torch.quantization import packing
    from bitblas_tpu_torch.testing import out_ulps
    ik, wd8 = dq.dequant_matmul_int, mz.weight_decode_int8
    fk, wdf = dq.dequant_matmul_fmt, mz.weight_decode_fmt
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    t0 = time.perf_counter()
    layers, quant, u4f16 = _int_layers(torch, gen)
    ins = {(K, M): torch.randint(-64, 64, (M, K), generator=gen,
                                 device="cuda", dtype=torch.int8)
           for K in {K for *_, K, _ in layers} for M in FORMAT_MS}
    fins = {M: torch.randn((M, 4096), generator=gen, device="cuda").half()
            for M in FORMAT_MS}
    build_s = time.perf_counter() - t0

    # the main path, counted
    torch.cuda.synchronize()
    for c in (ik, wd8, fk, wdf):
        c.launches = 0
    for c in (ik, fk):
        c.decode_launches = c.tiled_launches = 0
        c.format_launches.clear()
        c.variant_launches.clear()
    wd8.variant_launches.clear()
    wdf.format_launches.clear()
    outs = {}
    for w_dtype, kind, N, K, lin in layers:
        for M in FORMAT_MS:
            outs[(w_dtype, kind, M)] = lin(ins[(K, M)])
    qouts = {(bits, M): ql(ins[(4096, M)].float())
             for bits, ql in quant for M in (4, 256)}
    fouts = {(kind, M): lin(fins[M]) for kind, _, _, lin in u4f16
             for M in FORMAT_MS}
    torch.cuda.synchronize()
    launches = {}
    for key, n in ik.variant_launches.items():
        fmt, kind = key.split()[:2]
        name = f"dequant_matmul_int {kind} {fmt}"
        launches[name] = launches.get(name, 0) + n
    for key, n in fk.variant_launches.items():
        fmt, kind = key.split()[:2]
        name = f"dequant_matmul_fmt {kind} {fmt}"
        launches[name] = launches.get(name, 0) + n
    for fmt, n in wdf.format_launches.items():
        launches[f"weight_decode_fmt {fmt}"] = n
    launches["weight_decode_int8 1bit"] = sum(
        n for k, n in wd8.variant_launches.items() if k.endswith("1"))
    want = [f"dequant_matmul_int {k} {w}xint8" for w in
            {w for w, *_ in layers} for k in ("decode", "tiled")]
    want += ["weight_decode_int8 1bit",
             "dequant_matmul_fmt decode uint4xfloat16",
             "dequant_matmul_fmt tiled uint4xfloat16",
             "weight_decode_fmt uint4xfloat16"]
    missing = sorted(k for k in want if launches.get(k, 0) <= 0)
    if missing:
        raise AssertionError(f"int_formats: not launched: {missing}")
    emit({"phase": "int_formats_main_path", "layers": len(layers),
          "quant_linears": len(quant), "uint4_f16_layers": len(u4f16),
          "build_s": build_s, "launches": launches,
          "weight_decode_int8": dict(wd8.variant_launches),
          "decode_launches": ik.decode_launches,
          "tiled_launches": ik.tiled_launches})

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for w_dtype, kind, N, K, lin in layers:
        fmt = f"{w_dtype}xint8"
        cfg = lin.bitblas_matmul.config
        qw, sc, zr, b = lin.qweight, lin.scales, lin.zeros, lin.bias
        g = cfg.effective_group_size
        odt = getattr(torch, cfg.out_dtype)
        args = (qw, w_dtype, sc, zr, g, b, "original", odt)
        for M in FORMAT_MS:
            A = ins[(K, M)]
            out = outs[(w_dtype, kind, M)]
            again = lin(A)
            route = lin.bitblas_matmul.hint_for(M).decode_mode
            decode = route == "fused" and M <= 16
            ref = (dq.dequant_matmul_int_split_plain(A, *args, sms=sms)
                   if decode else dq.dequant_matmul_int_plain(A, *args))
            torch.cuda.synchronize()
            row = {"phase": "int_formats", "format": fmt, "layer": kind,
                   "M": M, "N": N, "K": K, "out": cfg.out_dtype,
                   "route": route,
                   "instance": "decode" if decode else "tiled"
                   if route == "fused" else None}
            if decode or sc is None:
                ok = torch.equal(out, ref)
                row["bit_equal"] = ok
            else:
                truth = _int_truth(torch, A, qw, w_dtype, sc, zr, g, None,
                                   b)
                row.update(_int_close(torch, out, ref, truth))
                ok = row.pop("ok")
                del truth
            row["max_abs_err"] = (out.double() - ref.double()).abs().max() \
                .item()
            if not (ok and torch.equal(out, again)):
                raise AssertionError(f"int_formats {fmt} {kind} M={M}: "
                                     f"{row}, two calls equal "
                                     f"{torch.equal(out, again)}")
            emit(row)
            rows.append(row)
    # kernel 1's instances timed on the g = 128 layers
    for w_dtype, kind, N, K, lin in layers:
        if kind != "g128":
            continue
        fmt = f"{w_dtype}xint8"
        bits = lin.bits
        qw, sc, zr, b = lin.qweight, lin.scales, lin.zeros, lin.bias
        g = FORMAT_GROUP
        codes = dq.decode_int_hopper(qw, w_dtype)
        wbytes = N * K * bits / 8 + 2 * (K // g) * N * (2 if zr is not None
                                                        else 1) + 4 * N
        for M, inst in ((4, "decode"), (256, "tiled")):
            A = ins[(K, M)]
            tile = dq.FUSED_TILES[fmt][0 if inst == "decode" else 1]
            Apad = torch.nn.functional.pad(A, (0, 0, 0, max(0, 17 - M)))
            nbytes = M * K + wbytes + M * N
            b_ms, b_by = bound(nbytes, 2.0 * M * N * K, INT8_OPS_PER_S)
            err = max(r["max_abs_err"] for r in rows if r["format"] == fmt
                      and r.get("instance") == inst)
            row = {"phase": "int_formats", "format": fmt, "kernel": inst,
                   "tile": list(tile), "M": M, "N": N, "K": K, "group": g,
                   "zeros": zr is not None, "out": "int8", "bias": True,
                   "max_abs_err": err,
                   "kernel_ms": time_ms(torch, lambda: ik(
                       A, qw, w_dtype, sc, zr, g, tile=tile, bias=b,
                       out_dtype=torch.int8), 20, flush),
                   "plain_ms": time_ms(torch, lambda: dq
                                       .dequant_matmul_int_plain(
                                           A, qw, w_dtype, sc, zr, g, b,
                                           "original", torch.int8), 3,
                                       flush),
                   "library_ms": time_ms(torch, lambda: torch._int_mm(
                       Apad, codes.T), 20, flush),
                   "stream_ms": time_ms(torch, _stream(torch, nbytes), 20,
                                        flush),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "timer_floor_ms": floor_ms}
            emit(row)
            rows.append(row)
        del codes
    # QuantLinear(bits, A_dtype="int8") against its plain version
    for bits, ql in quant:
        inner = ql.inner
        for M in (4, 256):
            A = ins[(4096, M)]
            out = qouts[(bits, M)]
            args = (inner.qweight, f"uint{bits}", inner.scales, inner.zeros,
                    ql.group_size, inner.bias, "original", torch.int8)
            ref = (dq.dequant_matmul_int_split_plain(A, *args, sms=sms)
                   if M <= 16 else dq.dequant_matmul_int_plain(A, *args))
            torch.cuda.synchronize()
            d = (out.int() - ref.int()).abs().max().item()
            if not (d <= (0 if M <= 16 else 1)
                    and torch.equal(out, ql(A.float()))):
                raise AssertionError(f"QuantLinear(bits={bits}, int8) M={M}: "
                                     f"{d} from the plain version")
            emit({"phase": "int_formats", "quant_linear_bits": bits,
                  "A_dtype": "int8", "M": M, "N": ql.out_features,
                  "K": ql.in_features, "int8_diff": d})
    # uint4 x float16 beyond GPTQ's options
    for kind, N, K, lin in u4f16:
        qw, sc, zr = lin.qweight, lin.scales, lin.zeros
        cfg = lin.bitblas_matmul.config
        g = cfg.effective_group_size
        odt = getattr(torch, cfg.out_dtype)
        for M in FORMAT_MS:
            A = fins[M]
            out = fouts[(kind, M)]
            route = lin.bitblas_matmul.hint_for(M).decode_mode
            if route == "fused" and M <= 16:
                ref = dq.dequant_matmul_fmt_split_plain(
                    A, qw, "uint4", sc, zr, g, out_dtype=odt, sms=sms)
            else:
                ref = dq.dequant_matmul_fmt_plain(A, qw, "uint4", sc, zr, g,
                                                  out_dtype=odt)
            torch.cuda.synchronize()
            ulps = out_ulps(out, ref)
            err = (out.float() - ref.float()).abs().max().item()
            ok = ulps <= 1 or (route == "materialize"
                               and err <= 4e-3 * ref.float().abs().max())
            if not (ok and torch.equal(out, lin(A))):
                raise AssertionError(f"uint4xfloat16 {kind} M={M} ({route}):"
                                     f" {ulps} ulps, {err}")
            row = {"phase": "int_formats", "format": "uint4xfloat16",
                   "layer": kind, "M": M, "N": N, "K": K,
                   "out": cfg.out_dtype, "route": route, "ulps": ulps,
                   "max_abs_err": err}
            emit(row)
            rows.append(row)
        if kind != "scales":
            continue
        Wd = mz.weight_decode_fmt_plain(qw, "uint4", "float16", sc, None, g)
        wbytes = N * K / 2 + 2 * (K // g) * N
        for M, inst in ((4, "decode"), (256, "tiled")):
            A = fins[M]
            tile = dq.FUSED_TILES["uint4xfloat16"][0 if inst == "decode"
                                                   else 1]
            nbytes = M * K * 2 + wbytes + M * N * 2
            b_ms, b_by = bound(nbytes, 2.0 * M * N * K)
            row = {"phase": "int_formats", "format": "uint4xfloat16",
                   "kernel": inst, "tile": list(tile), "M": M, "N": N,
                   "K": K, "group": g,
                   "max_abs_err": max(r["max_abs_err"] for r in rows
                                      if r["format"] == "uint4xfloat16"
                                      and r.get("layer") == kind),
                   "kernel_ms": time_ms(torch, lambda: fk(
                       A, qw, "uint4", sc, None, g, tile=tile), 20, flush),
                   "plain_ms": time_ms(torch, lambda: dq
                                       .dequant_matmul_fmt_plain(
                                           A, qw, "uint4", sc, None, g), 3,
                                       flush),
                   "library_ms": time_ms(torch, lambda: torch.matmul(
                       A, Wd.T), 20, flush),
                   "stream_ms": time_ms(torch, _stream(torch, nbytes), 20,
                                        flush),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "timer_floor_ms": floor_ms}
            emit(row)
            rows.append(row)
        dec = wdf(qw, "uint4", "float16", sc, None, g)
        torch.cuda.synchronize()
        if not torch.equal(dec, Wd):
            raise AssertionError("uint4xfloat16: kernel 2's weight differs")
        nbytes = wbytes + N * K * 2
        b_ms, b_by = bound(nbytes, 0.0)
        row = {"phase": "int_formats", "format": "uint4xfloat16",
               "kernel": "weight_decode", "N": N, "K": K, "group": g,
               "max_abs_err": 0.0,
               "kernel_ms": time_ms(torch, lambda: wdf(
                   qw, "uint4", "float16", sc, None, g), 20, flush),
               "plain_ms": time_ms(torch, lambda: mz.weight_decode_fmt_plain(
                   qw, "uint4", "float16", sc, None, g), 3, flush),
               "library_ms": None,
               "stream_ms": time_ms(torch, _stream(torch, nbytes), 20, flush),
               "bound_ms": b_ms, "bound_by": b_by, "timer_floor_ms": floor_ms}
        emit(row)
        rows.append(row)
        del Wd, dec

    # kernel 3 on every code of the six formats, and its 1-bit row timed
    codes_ok = []
    for family in ("uint", "int"):
        for bits in (1, 2, 4):
            codes = (torch.arange(64, device="cuda")[:, None] * 3
                     + torch.arange(1024, device="cuda")[None, :]) \
                % (1 << bits)
            qw = packing.pack_k(codes, bits)
            got = wd8(qw, bits, family)
            ref = mz.weight_decode_int8_plain(qw, bits, family)
            torch.cuda.synchronize()
            if not (torch.equal(got, ref)
                    and got.unique().numel() == 1 << bits):
                raise AssertionError(f"{family}{bits}: kernel 3 on every "
                                     f"code differs from the plain decode")
            codes_ok.append(f"{family}{bits}")
    emit({"phase": "int_formats_every_code", "formats": codes_ok})
    N, K = INT_SHAPES["int"]
    qw = _words(torch, gen, (N, K // 32))
    got = wd8(qw, 1, "int")
    ref = mz.weight_decode_int8_plain(qw, 1, "int")
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("kernel 3 at 1 bit differs from its plain "
                             "version")
    nbytes = N * K / 8 + N * K
    b_ms, b_by = bound(nbytes, 0.0)
    row = {"phase": "int_formats", "format": "int1", "kernel": "1bit",
           "N": N, "K": K, "max_abs_err": 0.0,
           "kernel_ms": time_ms(torch, lambda: wd8(qw, 1, "int"), 20, flush),
           "plain_ms": time_ms(torch, lambda: mz.weight_decode_int8_plain(
               qw, 1, "int"), 3, flush),
           "library_ms": None,
           "stream_ms": time_ms(torch, _stream(torch, nbytes), 20, flush),
           "bound_ms": b_ms, "bound_by": b_by, "timer_floor_ms": floor_ms}
    emit(row)
    rows.append(row)
    del got, ref, qw

    # the route table of each per-channel layer
    for w_dtype, kind, N, K, lin in layers:
        if kind != "per_channel":
            continue
        fmt = f"{w_dtype}xint8"
        spec = KernelSpec.from_config(lin.bitblas_matmul.config, 512)
        qw, sc = lin.qweight, lin.scales
        odt = getattr(torch, spec.out_dtype)
        for M in (256, 512, 2048):
            A = torch.randint(-64, 64, (M, K), generator=gen, device="cuda",
                              dtype=torch.int8)
            tile = dq.default_tile(fmt, M)
            a = ik(A, qw, w_dtype, sc, None, K, tile=tile, out_dtype=odt)
            b = mz.materialize_matmul(spec, A, qw, sc)
            ref = dq.dequant_matmul_int_plain(A, qw, w_dtype, sc, None, K,
                                              out_dtype=odt)
            truth = _int_truth(torch, A, qw, w_dtype, sc, None, K, None,
                               None)
            torch.cuda.synchronize()
            ca = _int_close(torch, a, ref, truth)
            cb = _int_close(torch, b, ref, truth)
            del truth
            row = {"phase": "int_route", "format": fmt, "M": M, "N": N,
                   "K": K, "out": spec.out_dtype, "fused_tile": list(tile),
                   "fused_ok": ca["ok"], "materialize_ok": cb["ok"],
                   "fused_ms": time_ms(torch, lambda: ik(
                       A, qw, w_dtype, sc, None, K, tile=tile,
                       out_dtype=odt), 20, flush),
                   "materialize_ms": time_ms(
                       torch, lambda: mz.materialize_matmul(spec, A, qw, sc),
                       20, flush)}
            row["faster"] = ("materialize" if row["materialize_ms"]
                             < row["fused_ms"] else "fused")
            if not (ca["ok"] and cb["ok"]):
                raise AssertionError(f"int route {fmt} M={M}: {row}")
            emit(row)
    del layers, quant, u4f16, outs, qouts, fouts, ins, fins
    torch.cuda.empty_cache()
    return rows, launches


GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden", "gptq_golden_256x256_g64.npz")


def _within(torch, got, want, rtol, atol, ratio) -> bool:
    """At most `ratio` of the elements outside atol + rtol |want|."""
    bad = (got.float() - want.float()).abs() > atol + rtol * want.float().abs()
    return bad.sum().item() <= math.ceil(ratio * want.numel())


def check_gptq_golden(torch):
    """The committed AutoGPTQ golden (tests/golden, g = 64) on the card:
    module.Linear (zeros mode quantized) and QuantLinear repacked from its
    v1 and v2 tensors; the identity through each (16-row chunks: the
    decode instance; 32-row: the tiled one) gives the golden's dequantized
    weight bit for bit; the 2-layer forward gives its logits within
    tests/test_gptq_golden.py's tolerance (rtol 2e-2, atol 2e-2 of the
    largest, at most 0.1% of the elements outside)."""
    import numpy as np
    from types import SimpleNamespace
    from bitblas_tpu_torch.integration.pytorch import QuantLinear
    from bitblas_tpu_torch.module import Linear
    gold = np.load(GOLDEN)
    t = {k: torch.from_numpy(gold[k]).cuda() for k in gold.files}
    eye = torch.eye(256, dtype=torch.float16, device="cuda")
    out = {"phase": "gptq_golden", "group": 64}
    for v2 in (False, True):
        sfx = "_v2" if v2 else ""
        layers = {}
        for li in (1, 2):
            stub = SimpleNamespace(qweight=t[f"l{li}/qweight{sfx}"],
                                   qzeros=t[f"l{li}/qzeros{sfx}"],
                                   scales=t[f"l{li}/scales"])
            lin = Linear(256, 256, A_dtype="float16", W_dtype="uint4",
                         group_size=64, with_scaling=True, with_zeros=True,
                         zeros_mode="quantized", opt_M=[16],
                         enable_tuning=False, device="cuda")
            ql = QuantLinear(4, 64, 256, 256, bias=False, device="cuda")
            for m in (lin, ql):
                getattr(m, "repack_from_gptq_v2" if v2 else
                        "repack_from_gptq")(stub)
            want = t[f"l{li}/dequant_w"].half()              # [in, out]
            for name, m in (("linear", lin), ("quant_linear", ql)):
                for rows in (16, 32):
                    got = torch.cat([m(eye[o:o + rows])
                                     for o in range(0, 256, rows)])
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"gptq_golden {name} v2={v2} layer {li}: the "
                            f"dequantized weight differs ({rows}-row "
                            f"chunks)")
            layers[li] = (lin, ql)
        for name, k in (("linear", 0), ("quant_linear", 1)):
            logits = layers[2][k](layers[1][k](t["x"])).float()
            ref = t["logits"]
            atol = 0.02 * ref.abs().max().item()
            err = (logits - ref).abs().max().item()
            if not _within(torch, logits, ref, 2e-2, atol, 1e-3):
                raise AssertionError(f"gptq_golden {name} v2={v2}: logits "
                                     f"max abs err {err} (atol {atol})")
            out[f"{name}_{'v2' if v2 else 'v1'}_logit_max_abs_err"] = err
    out["dequant_bit_equal"] = True
    emit(out)


def check_linear(torch):
    """A synthetic AutoGPTQ bundle at 4096 -> 11008 (Llama-2-7B's gate /
    up), g = 128 and 64, drawn on the card: module.Linear repacked from
    the v1 tensors, QuantLinear from the v2 tensors (the same codes and
    zeros); the unpacked codes and zeros equal the drawn ones; forwards at
    M = 1 / 16 / 256 / 1024 within 4e-3 of the plain version's largest
    output, the two layers bit-equal; a save_quant_state /
    load_quant_state round trip on the card bit for bit, and a
    checkpoint stamped with the JAX package's layout refused."""
    from types import SimpleNamespace
    from bitblas_tpu_torch.integration.pytorch import QuantLinear
    from bitblas_tpu_torch.kernels.dequant_matmul import (
        dequant_matmul_u4_plain)
    from bitblas_tpu_torch.module import Linear
    from bitblas_tpu_torch.module.checkpoint import (load_quant_state,
                                                     save_quant_state)
    from bitblas_tpu_torch.quantization.packing import pack_autogptq
    K, N = 4096, 11008
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    tmp = tempfile.mkdtemp(prefix="bitblas_tpu_torch_ckpt_")
    try:
        for g in (128, 64):
            codes = torch.randint(0, 16, (K, N), generator=gen,
                                  device="cuda")
            zeros = torch.randint(1, 15, (K // g, N), generator=gen,
                                  device="cuda")
            scales = (torch.rand((K // g, N), generator=gen, device="cuda")
                      * 0.01 + 0.005).half()
            bias = torch.randn(N, generator=gen, device="cuda").half()
            stubs = [SimpleNamespace(**dict(zip(
                ("qweight", "qzeros", "scales"),
                pack_autogptq(codes, zeros, scales, 4, v2=v2))), bias=bias)
                for v2 in (False, True)]
            lin = Linear(K, N, bias=True, A_dtype="float16",
                         W_dtype="uint4", group_size=g, with_scaling=True,
                         with_zeros=True, zeros_mode="original",
                         enable_tuning=False, device="cuda")
            got_codes, got_z = lin.repack_from_gptq(stubs[0])
            if not (torch.equal(got_codes.long(), codes.T)
                    and torch.equal(got_z.long(), zeros)):
                raise AssertionError(f"linear g={g}: unpacked codes or "
                                     f"zeros differ from the drawn ones")
            ql = QuantLinear(4, g, K, N, bias=True, device="cuda")
            ql.repack_from_gptq_v2(stubs[1])
            routes = {}
            for M in (1, 16, 256, 1024):
                A = torch.randn((M, K), generator=gen, device="cuda").half()
                out = lin(A)
                ref = dequant_matmul_u4_plain(A, lin.qweight, lin.scales,
                                              lin.zeros, g, bias=lin.bias)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                tol = 4e-3 * ref.float().abs().max().item()
                if not (err <= tol and torch.isfinite(out).all().item()
                        and torch.equal(ql(A), out)):
                    raise AssertionError(f"linear g={g} M={M}: err {err} "
                                         f"(tol {tol}) or QuantLinear "
                                         f"differs")
                routes[M] = lin.bitblas_matmul.hint_for(M).short_name()
            path = os.path.join(tmp, f"linear_g{g}")
            state = {"proj": dict(lin.state_dict())}
            save_quant_state(path, state)
            back = load_quant_state(path, device="cuda")["proj"]
            if set(back) != set(state["proj"]) or not all(
                    torch.equal(back[k], v) for k, v in state["proj"].items()):
                raise AssertionError(f"linear g={g}: checkpoint round trip "
                                     f"differs")
            with open(path + ".npz.meta.json", "w") as f:
                json.dump({"device_layout_version": 2}, f)
            try:
                load_quant_state(path, device="cuda")
            except ValueError:
                pass
            else:
                raise AssertionError("a JAX-stamped checkpoint was loaded")
            emit({"phase": "linear", "in": K, "out": N, "group": g,
                  "routes": routes, "checkpoint_round_trip": True,
                  "jax_checkpoint_refused": True})
    finally:
        shutil.rmtree(tmp)


# meta-llama/Llama-2-7b-hf config.json, as a HF config dict
LLAMA2_7B_HF = {"hidden_size": 4096, "intermediate_size": 11008,
                "num_attention_heads": 32, "num_key_value_heads": 32,
                "num_hidden_layers": 32, "vocab_size": 32000,
                "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
                "model_type": "llama"}
GPTQ_PROJS = (("self_attn.q_proj", 4096, 4096),
              ("self_attn.k_proj", 4096, 4096),
              ("self_attn.v_proj", 4096, 4096),
              ("self_attn.o_proj", 4096, 4096),
              ("mlp.gate_proj", 4096, 11008), ("mlp.up_proj", 4096, 11008),
              ("mlp.down_proj", 11008, 4096))     # (name, K = in, N = out)


def gptq_state(torch, num_layers: int, group: int, seed: int):
    """An AutoGPTQ v1 (desc_act=False) state dict at Llama-2-7B widths,
    drawn on the card from `seed`: random qweight words (every code
    occurs), zero point 8 (v1 stores 7), scales 0.001 +- 0.0002 (the
    random residual stream stays contractive, as QuantLlama's own random
    init keeps it), unit norms, embedding and lm_head * 0.05."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    state = {}
    for i in range(num_layers):
        base = f"model.layers.{i}"
        for name, K, N in GPTQ_PROJS:
            key = f"{base}.{name}"
            state[f"{key}.qweight"] = _words(torch, gen, (K // 8, N))
            state[f"{key}.qzeros"] = torch.full(
                (K // group, N // 8), 0x77777777, dtype=torch.int32,
                device="cuda")
            state[f"{key}.scales"] = (torch.randn(
                (K // group, N), generator=gen, device="cuda") * 0.0002
                + 0.001).half()
        for norm in ("input_layernorm", "post_attention_layernorm"):
            state[f"{base}.{norm}.weight"] = torch.ones(4096, device="cuda")
    state["model.embed_tokens.weight"] = (torch.randn(
        (32000, 4096), generator=gen, device="cuda") * 0.05).half()
    state["model.norm.weight"] = torch.ones(4096, device="cuda")
    state["lm_head.weight"] = torch.randn((32000, 4096), generator=gen,
                                          device="cuda") * 0.05
    return state


GPTQ_GROUP = 64


def check_gptq_reference(torch):
    """The imported model, 2 layers: card against CPU (the same state
    dict imported on each) at check_reference's tolerance."""
    from bitblas_tpu_torch.models.hf_import import (
        load_quant_llama_from_hf_gptq)
    hf = dict(LLAMA2_7B_HF, num_hidden_layers=2)
    state = gptq_state(torch, 2, GPTQ_GROUP, seed=21)
    gpu, _ = load_quant_llama_from_hf_gptq(state, hf, group_size=GPTQ_GROUP,
                                           device="cuda")
    cpu, _ = load_quant_llama_from_hf_gptq(
        {k: v.cpu() for k, v in state.items()}, hf, group_size=GPTQ_GROUP,
        device="cpu")
    with CpuWeightMemo():
        reference_steps(torch, gpu.cfg, gpu, cpu, "reference_gptq")
    del gpu, cpu, state
    torch.cuda.empty_cache()


def gptq_serving_model(torch):
    """The 32-layer model imported from a GPTQ state dict at Llama-2-7B
    widths (g = 64), with serving_model's prompts."""
    import numpy as np
    from bitblas_tpu_torch.models.hf_import import (
        load_quant_llama_from_hf_gptq)
    t0 = time.perf_counter()
    state = gptq_state(torch, 32, GPTQ_GROUP, seed=7)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, head = load_quant_llama_from_hf_gptq(
        state, LLAMA2_7B_HF, group_size=GPTQ_GROUP, device="cuda")
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    del state
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    V = model.cfg.vocab_size
    prompts = [rng.integers(0, V, n).astype(np.int32)
               for n in (200, 300, 450, 500)]
    prefix = rng.integers(0, V, 256)
    pair = [np.concatenate([prefix, rng.integers(0, V, n)]).astype(np.int32)
            for n in (40, 90)]
    packed = sum(t.numel() * t.element_size()
                 for n, t in model.named_buffers() if "qweight" in n or
                 "scales" in n or "zeros" in n)
    emit({"phase": "gptq_import", "layers": 32, "group": GPTQ_GROUP,
          "state_draw_s": draw_s, "import_s": import_s,
          "weight_bytes": packed})
    return {"cfg": model.cfg, "model": model, "head": head,
            "prompts": prompts, "pair": pair, "init_s": import_s,
            "name": f"Llama-2-7B widths, AutoGPTQ v1 g{GPTQ_GROUP} import",
            "weight_bytes": packed}


# -- the ops phase (the operator surface at full width) ----------------------
#
# ResNet-50's residual-stage convolutions, the shapes the JAX package's
# scripts/tpu_conv_bench.py:22-28 measures: (C, H = W, F, K, S, P), batch 32
CONV_SHAPES = ((128, 28, 128, 3, 1, 1), (256, 14, 256, 3, 1, 1),
               (1024, 14, 256, 1, 1, 0), (512, 7, 512, 3, 1, 1))
CONV_BATCH = 32
CONV_GROUP = 128
# MatmulWithSplitK at Llama-2-7B's projections (N, K), uint4 g128 with
# zeros; k_split 2 and 4 where K / k_split stays a multiple of 128
SPLITK_SHAPES = ((4096, 4096), (11008, 4096), (4096, 11008))
SPLITK_MS = (1, 4, 16)
# BatchMatmul at Llama-2-7B's attention product: 32 heads, M = N = 512,
# K = 128 (head dim)
BMM_SHAPE = (32, 512, 512, 128)
# the permutes' weight: Llama-2-7B's gate / up projection (N, K)
PERMUTE_SHAPE = (11008, 4096)
PERMUTE_CHECK_ROWS = 512      # rows held against the CPU op
# Limits, in float16 ulps of each output plus SPLIT_ULP_FLOOR of the
# largest (f16_ulps). A cuDNN float16 convolution against the float32
# convolution of the same values: one rounding each of float32 sums in
# other orders, so within one ulp where both sums sit on one side of a
# rounding boundary and two where they straddle it: OPS_CONV_ULPS = 2
# (0.99 read at every shape on an H100 at 700 W). The materialize route
# rounds the convolution to float16, adds the float32 bias and rounds
# again (the port's materialize plan does the same after its library
# product): its distance from the plain version's single rounding is held
# in units of one ulp of the unbiased convolution plus one of the output,
# at most OPS_MATERIALIZE_RATIO (0.94-0.96 read; in plain ulps 13.5 at the
# first shape, where a bias cancels the convolution to near zero). Kernel
# 1's fused outputs against their plain version: one ulp, as the formats
# phase holds them (0.991 read).
OPS_CONV_ULPS = 2.0
OPS_MATERIALIZE_RATIO = 2.0
OPS_FUSED_ULPS = 1.0


def _conv_plain(torch, x, w_oihw, c, bias=None):
    """The plain convolution on the card: float32 sums of the float32
    copies (TF32 off), the bias added in float32, one rounding to float16;
    NHWC in and out."""
    import torch.nn.functional as F
    from bitblas_tpu_torch.kernels.dense import full_f32
    with full_f32():
        out = F.conv2d(x.permute(0, 3, 1, 2).float(), w_oihw.float(),
                       stride=c.S, padding=c.P, dilation=c.D)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1).float()
    return out.permute(0, 2, 3, 1).half()


def _conv_case(torch, gen, shape):
    """One ResNet-50 shape: its operators (dense Conv2D f16; QuantConv2D
    uint4 g128 with a bias on both routes; int8 activations, uint4 per
    channel, on both routes), operands and packed filters."""
    from bitblas_tpu_torch import (Conv2D, Conv2DConfig, QuantConv2D,
                                   QuantConv2DConfig)
    C, H, F_, K, S, P = shape
    g = dict(N=CONV_BATCH, C=C, H=H, W=H, F=F_, K=K, S=S, P=P)
    kdim = C * K * K
    case = {"shape": shape, "g": g, "kdim": kdim}
    case["x"] = torch.randn((CONV_BATCH, H, H, C), generator=gen,
                            device="cuda").half()
    case["xi"] = torch.randint(-64, 64, (CONV_BATCH, H, H, C), generator=gen,
                               device="cuda", dtype=torch.int8)
    case["w"] = (torch.randn((K, K, C, F_), generator=gen, device="cuda")
                 / math.sqrt(kdim)).half()
    codes = torch.randint(0, 16, (K, K, C, F_), generator=gen, device="cuda",
                          dtype=torch.uint8)
    scale_g = (torch.rand((F_, kdim // CONV_GROUP), generator=gen,
                          device="cuda") * 0.01 + 0.005).half()
    scale_c = (torch.rand((F_, 1), generator=gen, device="cuda") * 0.01
               + 0.005).half()
    bias = torch.randn(F_, generator=gen, device="cuda")
    case["dense"] = Conv2D(Conv2DConfig(**g))
    q = dict(g, W_dtype="uint4", group_size=CONV_GROUP, with_scaling=True)
    qi = dict(g, W_dtype="uint4", group_size=-1, with_scaling=True,
              in_dtype="int8", accum_dtype="int32", out_dtype="float32")
    for route in ("materialize", "fused"):
        case[route] = QuantConv2D(QuantConv2DConfig(**q, route=route))
        case[f"int_{route}"] = QuantConv2D(QuantConv2DConfig(**qi,
                                                             route=route))
        if case[route].route != route or case[f"int_{route}"].route != route:
            raise AssertionError(f"ops: QuantConv2D took another route "
                                 f"than {route} at {shape}")
    for fused in ("fused", "int_fused"):
        if case[fused].matmul.hint_for(case[fused].m).decode_mode != "fused":
            raise AssertionError(f"ops: {fused} at {shape} is not pinned to "
                                 f"kernel 1")
    case["W"], case["S"], case["B"] = case["materialize"].transform_weight(
        codes, scale=scale_g, bias=bias)
    case["Wi"], case["Si"] = case["int_materialize"].transform_weight(
        codes, scale=scale_c)
    return case


def _conv_run(case, kind):
    """One forward of the case's operator `kind` through its public API."""
    if kind == "dense":
        return case["dense"](case["x"], case["w"])
    if kind in ("materialize", "fused"):
        return case[kind](case["x"], case["W"], scale=case["S"],
                          bias=case["B"])
    return case[kind](case["xi"], case["Wi"], scale=case["Si"])


def _splitk_cases(torch, gen):
    """MatmulWithSplitK beside Matmul at Llama-2-7B's projection shapes,
    uint4 g128 with zeros (GPTQ's layout)."""
    from bitblas_tpu_torch import (Matmul, MatmulConfig,
                                   MatmulConfigWithSplitK, MatmulWithSplitK)
    cases = []
    for N, K in SPLITK_SHAPES:
        codes = torch.randint(0, 16, (N, K), generator=gen, device="cuda",
                              dtype=torch.uint8)
        groups = (N, K // CONV_GROUP)
        scales = (torch.rand(groups, generator=gen, device="cuda") * 0.01
                  + 0.005).half()
        zeros = torch.randint(0, 16, groups, generator=gen,
                              device="cuda").half()
        kw = dict(M=SPLITK_MS, N=N, K=K, A_dtype="float16", W_dtype="uint4",
                  with_scaling=True, with_zeros=True, group_size=CONV_GROUP)
        full = Matmul(MatmulConfig(**kw), enable_tuning=False)
        case = {"N": N, "K": K, "full": full,
                "packed": full.transform_weight(codes, scale=scales,
                                                zeros=zeros),
                "A": {m: torch.randn((m, K), generator=gen,
                                     device="cuda").half()
                      for m in SPLITK_MS}, "split": {}}
        for ks in (2, 4):
            if (K // ks) % CONV_GROUP:
                continue
            op = MatmulWithSplitK(MatmulConfigWithSplitK(**kw, k_split=ks),
                                  enable_tuning=False)
            case["split"][ks] = (op, op.transform_weight(
                codes, scale=scales, zeros=zeros))
        cases.append(case)
    return cases


def _f16_ulp(torch, x):
    e = torch.frexp(x.double().abs().clamp_min(2.0 ** -14))[1] - 1
    return torch.exp2(e.double() - 10)


def _splitk_check(torch, op, packed, A, got):
    """A split-K output against the sum of its shards' plain versions (the
    decode instance's split arithmetic, `dequant_matmul_u4_split_plain`),
    summed in float32 and rounded: each shard of the kernel lies within one
    f16 ulp of its plain shard, so the two sums differ by at most those
    ulps and one of the output (plus SPLIT_ULP_FLOOR of the largest).
    Returns (the largest ratio to that bound, max abs error)."""
    from bitblas_tpu_torch.kernels import dequant_matmul as dq
    W, S, Z = packed
    kk = op.shard_k
    gk = kk // CONV_GROUP
    parts = [dq.dequant_matmul_u4_split_plain(
        A[:, s * kk:(s + 1) * kk].contiguous(), W[s],
        S[s * gk:(s + 1) * gk], Z[s * gk:(s + 1) * gk])
        for s in range(op.k_split)]
    ref = sum(p.float() for p in parts).half()
    unit = sum(_f16_ulp(torch, p) for p in parts) + _f16_ulp(torch, ref) \
        + SPLIT_ULP_FLOOR * ref.double().abs().max()
    err = (got.double() - ref.double()).abs()
    return (err / unit).max().item(), err.max().item()


def check_ops(torch, flush):
    """The ops phase: the operator surface at full width on the card.

    First the main path alone, through the operators' public calls, with
    the launch counters of kernels 1-3 set to 0 just before and read just
    after: at each ResNet-50 shape (CONV_SHAPES, batch 32) a dense Conv2D
    (f16), QuantConv2D uint4 g128 with a bias on the materialize route
    (kernel 2, weight_decode_fmt) and the fused one (kernel 1's tiled
    instance, dequant_matmul_fmt), and with int8 activations (uint4 per
    channel) on both (kernel 3, weight_decode_int8; dequant_matmul_int);
    MatmulWithSplitK at Llama-2-7B's projections, M = 1 / 4 / 16, k_split
    2 and 4 (kernel 1's decode instance a shard); BatchMatmul f16 and
    int8 at the attention product; QuantCompress, LOP3Permutate (and its
    inverse) and LadderPermutate at 11008 x 4096. Every kernel of that
    path must have launched.

    Then, outside that count, each op against its plain PyTorch version
    on the card: the dense convolution and the materialize route against
    the float32 convolution (OPS_CONV_ULPS / OPS_MATERIALIZE_RATIO), kernel
    2's filter bit-equal to its plain decode; the fused route within
    OPS_FUSED_ULPS of kernel 1's plain version; the int8 materialize route
    bit-equal to the exact integer convolution times the scales, kernel
    3's codes bit-equal; the int8 fused route within one ulp of its plain
    version or nearer the float64 truth (`_int_close`); split-K within the
    shards' roundings of its plain shards (`_splitk_check`); BatchMatmul
    f16 within one ulp of float32 sums, int8 bit-equal; the permutes'
    first PERMUTE_CHECK_ROWS rows bit-equal to the same op on the CPU,
    LOP3's inverse the identity on the card.

    Then the timed rows (measure_kernel, 20 launches, L2 flushed): per
    conv shape the dense, materialize and fused ms (and the int8 routes'),
    kernel 2's ms and its share of the materialize route, each against
    its bound (bytes over 3.35 TB/s: x, the filter as stored, the output;
    operations 2 N Ho Wo F C K K over 989 TFLOP/s f16 or 1979 TOP/s int8);
    kernels 1-3 alone at those shapes with their plain and library ms;
    split-K beside Matmul, with launches a call; BatchMatmul; and
    measure_chained beside measure_kernel(flush=False) for kernel 1's
    decode instance (M = 4, N = 11008, K = 4096). Returns (rows, launches
    by kernels-line name)."""
    import torch.nn.functional as F
    from bitblas_tpu_torch import (BatchMatmul, BatchMatmulConfig,
                                   LadderPermutate, LadderPermutateConfig,
                                   LOP3Permutate, LOP3PermutateConfig,
                                   QuantCompress, QuantCompressConfig)
    from bitblas_tpu_torch.kernels import dequant_matmul as dq
    from bitblas_tpu_torch.kernels import materialize as mz
    from bitblas_tpu_torch.ops.batch_matmul import batch_matmul_plain
    from bitblas_tpu_torch.ops.conv2d import conv_patches
    from bitblas_tpu_torch.testing import out_ulps
    from bitblas_tpu_torch.utils.timing import (make_chained,
                                                measure_chained,
                                                measure_kernel)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    t0 = time.perf_counter()
    convs = [_conv_case(torch, gen, s) for s in CONV_SHAPES]
    splitk = _splitk_cases(torch, gen)
    B, M, N, K = BMM_SHAPE
    bmm = {}
    for dtype, out in (("float16", "float16"), ("int8", "int32")):
        op = BatchMatmul(BatchMatmulConfig(
            Batch=B, M=M, N=N, K=K, A_dtype=dtype, W_dtype=dtype,
            out_dtype=out,
            accum_dtype="int32" if dtype == "int8" else "float32"))
        if dtype == "int8":
            a = torch.randint(-128, 128, (B, M, K), generator=gen,
                              device="cuda", dtype=torch.int8)
            w = torch.randint(-128, 128, (B, N, K), generator=gen,
                              device="cuda", dtype=torch.int8)
        else:
            a = torch.randn((B, M, K), generator=gen, device="cuda").half()
            w = torch.randn((B, N, K), generator=gen, device="cuda").half()
        bmm[dtype] = (op, a, w)
    PN, PK = PERMUTE_SHAPE
    pcodes = torch.randint(0, 16, PERMUTE_SHAPE, generator=gen,
                           device="cuda", dtype=torch.int8)
    perm_ops = {
        "quant_compress": lambda dev, m=PN: QuantCompress(
            QuantCompressConfig(M=m, N=PK, dequantize_bits=4), device=dev),
        "lop3": lambda dev, m=PN: LOP3Permutate(
            LOP3PermutateConfig(M=m, N=PK, dequantize_bits=4), device=dev),
        "ladder": lambda dev, m=PN: LadderPermutate(
            LadderPermutateConfig(M=m, N=PK, dequantize_bits=4), device=dev)}
    perms = {k: f("cuda") for k, f in perm_ops.items()}
    build_s = time.perf_counter() - t0

    # the main path, counted
    u4, fk, ik = dq.dequant_matmul_u4, dq.dequant_matmul_fmt, \
        dq.dequant_matmul_int
    wdf, wd8, wdu = mz.weight_decode_fmt, mz.weight_decode_int8, \
        mz.weight_decode_u4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in (u4, fk, ik, wdf, wd8, wdu):
        c.launches = 0
        for attr in ("variant_launches", "format_launches"):
            if hasattr(c, attr):
                getattr(c, attr).clear()
    for c in (u4, fk, ik):
        c.decode_launches = c.tiled_launches = 0
    kinds = ("dense", "materialize", "fused", "int_materialize", "int_fused")
    outs = {(i, kind): _conv_run(case, kind)
            for i, case in enumerate(convs) for kind in kinds}
    souts = {}
    for i, case in enumerate(splitk):
        for ks, (op, (W, S, Z)) in case["split"].items():
            for m, A in case["A"].items():
                souts[(i, ks, m)] = op(A, W, scale=S, zeros=Z)
    bouts = {d: op(a, w) for d, (op, a, w) in bmm.items()}
    packed4 = perms["quant_compress"](pcodes)
    pouts = {"quant_compress": packed4,
             "lop3": perms["lop3"](packed4),
             "ladder": perms["ladder"](pcodes)}
    pouts["lop3_inverse"] = perms["lop3"].inverse(pouts["lop3"])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {
        "dequant_matmul_u4": u4.launches,
        DECODE["uint4"]: u4.decode_launches,
        "dequant_matmul_fmt tiled uint4xfloat16": sum(
            n for k, n in fk.variant_launches.items()
            if k.startswith("uint4xfloat16 tiled")),
        "weight_decode_fmt uint4xfloat16":
            wdf.format_launches.get("uint4xfloat16", 0),
        "dequant_matmul_int tiled uint4xint8": sum(
            n for k, n in ik.variant_launches.items()
            if k.startswith("uint4xint8 tiled")),
        "weight_decode_int8 uint4": wd8.variant_launches.get("uint4", 0)}
    missing = sorted(k for k, n in launches.items() if n <= 0)
    if missing:
        raise AssertionError(f"ops: not launched on the main path: "
                             f"{missing}")
    emit({"phase": "ops_main_path", "build_s": build_s, "main_s": main_s,
          "launches": launches,
          "variant_launches": {"dequant_matmul_u4": dict(u4.variant_launches),
                               "dequant_matmul_fmt": dict(
                                   fk.variant_launches),
                               "dequant_matmul_int": dict(
                                   ik.variant_launches)}})

    # each op against its plain version on the card
    t0 = time.perf_counter()
    rows = {"conv": [], "kernels": [], "splitk": [], "bmm": [],
            "permute": {}}
    bad = []
    for i, case in enumerate(convs):
        c, g, kdim = case["fused"].config, case["g"], case["kdim"]
        C, H, F_, Kk, S_, P = case["shape"]
        for kind in kinds:
            out = outs[(i, kind)]
            ho, wo = c.out_hw
            want_shape = (CONV_BATCH, ho, wo, F_)
            if tuple(out.shape) != want_shape or \
                    not bool(torch.isfinite(out).all()):
                raise AssertionError(f"ops: {kind} at {case['shape']}: "
                                     f"{tuple(out.shape)}, finite "
                                     f"{bool(torch.isfinite(out).all())}")
        x, W, Sc, Bi = case["x"], case["W"], case["S"], case["B"]
        read = {}
        ref = _conv_plain(torch, x, case["w"].permute(3, 2, 0, 1), c)
        read["dense_ulps"] = f16_ulps(torch, outs[(i, "dense")], ref)
        wplain = mz.weight_decode_fmt_plain(W, "uint4", "float16", Sc, None,
                                            CONV_GROUP)
        wcard = mz.weight_decode_fmt(W, "uint4", "float16", Sc, None,
                                     CONV_GROUP)
        read["kernel2_bit_equal"] = bool(torch.equal(wcard, wplain))
        w_oihw = wplain.reshape(F_, C, Kk, Kk)
        ref = _conv_plain(torch, x, w_oihw, c, Bi)
        unit = _f16_ulp(torch, _conv_plain(torch, x, w_oihw, c)) \
            + _f16_ulp(torch, ref) + SPLIT_ULP_FLOOR * ref.double().abs().max()
        out_m = outs[(i, "materialize")]
        read["materialize_ratio"] = ((out_m.double() - ref.double()).abs()
                                     / unit).max().item()
        read["materialize_ulps"] = f16_ulps(torch, out_m, ref)
        patches = conv_patches(x, c).contiguous()
        ref = dq.dequant_matmul_fmt_plain(patches, W, "uint4", Sc, None,
                                          CONV_GROUP, bias=Bi)
        read["fused_ulps"] = f16_ulps(
            torch, outs[(i, "fused")].reshape(-1, F_), ref)
        read["fused_max_abs_err"] = (outs[(i, "fused")].reshape(-1, F_)
                                     .float() - ref.float()).abs().max() \
            .item()
        Wi, Si = case["Wi"], case["Si"]
        codes_plain = mz.weight_decode_int8_plain(Wi, 4, "uint")
        read["kernel3_bit_equal"] = bool(torch.equal(
            mz.weight_decode_int8(Wi, 4, "uint"), codes_plain))
        pi = conv_patches(case["xi"], c).contiguous()
        exact = pi.double() @ codes_plain.double().T      # exact sums
        ref_i = (exact.float() * Si.reshape(1, -1).float())
        read["int_materialize_bit_equal"] = bool(torch.equal(
            outs[(i, "int_materialize")].reshape(-1, F_), ref_i))
        truth = exact * Si.reshape(1, -1).double()
        ref_f = dq.dequant_matmul_int_plain(pi, Wi, "uint4", Si, None, -1)
        close = _int_close(torch, outs[(i, "int_fused")].reshape(-1, F_),
                           ref_f, truth)
        read["int_fused"] = close
        read["int_fused_max_abs_err"] = (outs[(i, "int_fused")]
                                         .reshape(-1, F_).double()
                                         - truth).abs().max().item()
        ok = (read["dense_ulps"] <= OPS_CONV_ULPS
              and read["materialize_ratio"] <= OPS_MATERIALIZE_RATIO
              and read["fused_ulps"] <= OPS_FUSED_ULPS
              and read["kernel2_bit_equal"] and read["kernel3_bit_equal"]
              and read["int_materialize_bit_equal"] and close["ok"])
        emit({"phase": "ops_conv_check", "shape": case["shape"], **read})
        if not ok:
            bad.append((case["shape"], read))
        case["read"], case["patches"], case["pi"] = read, patches, pi
        case["wcard"], case["codes_plain"] = wcard, codes_plain
    for i, case in enumerate(splitk):
        for ks, (op, packed) in case["split"].items():
            for m, A in case["A"].items():
                ratio, err = _splitk_check(torch, op, packed, A,
                                           souts[(i, ks, m)])
                full = case["full"](A, case["packed"][0],
                                    scale=case["packed"][1],
                                    zeros=case["packed"][2])
                vs_full = f16_ulps(torch, souts[(i, ks, m)], full)
                rows["splitk"].append({
                    "N": case["N"], "K": case["K"], "M": m, "k_split": ks,
                    "bound_ratio": ratio, "max_abs_err": err,
                    "ulps_vs_matmul": vs_full})
                if not ratio <= 1.0:
                    bad.append((case["N"], case["K"], m, ks, ratio))
    for dtype, (op, a, w) in bmm.items():
        ref = batch_matmul_plain(a, w, "nt", bouts[dtype].dtype)
        if dtype == "int8":
            good = bool(torch.equal(bouts[dtype], ref))
            reading = {"bit_equal": good}
        else:
            reading = {"ulps": out_ulps(bouts[dtype], ref)}
            good = reading["ulps"] <= 1.0
        rows["bmm"].append({"dtype": dtype, **reading})
        if not good:
            bad.append((dtype, reading))
    r = PERMUTE_CHECK_ROWS
    cpu = {k: f("cpu", r) for k, f in perm_ops.items()}
    for name, got, x in (("quant_compress", pouts["quant_compress"], pcodes),
                         ("lop3", pouts["lop3"], packed4),
                         ("ladder", pouts["ladder"], pcodes)):
        # rows are independent: the first r against the CPU op on them
        rows["permute"][name] = bool(torch.equal(
            got[:r].cpu(), cpu[name](x[:r].cpu())))
    rows["permute"]["lop3_inverse_identity"] = bool(torch.equal(
        pouts["lop3_inverse"], packed4))
    emit({"phase": "ops_check", "seconds": time.perf_counter() - t0,
          "splitk": rows["splitk"], "bmm": rows["bmm"],
          "permute": rows["permute"]})
    if bad or not all(rows["permute"].values()):
        raise AssertionError(f"ops: disagree with their plain versions: "
                             f"{bad}, permutes {rows['permute']}")

    # timed rows
    t0 = time.perf_counter()
    for i, case in enumerate(convs):
        c, kdim = case["fused"].config, case["kdim"]
        C, H, F_, Kk, S_, P = case["shape"]
        ho, wo = c.out_hw
        M_ = CONV_BATCH * ho * wo
        x_bytes, out_bytes = CONV_BATCH * H * H * C, M_ * F_
        flops = 2 * M_ * F_ * kdim
        packed_bytes = F_ * kdim // 2
        scale_bytes = 2 * F_ * kdim // CONV_GROUP
        row = {"shape": case["shape"], "M": M_, "K": kdim, "N": F_}
        for kind in kinds:
            row[f"{kind}_ms"] = time_ms(
                torch, lambda k=kind: _conv_run(case, k), 20, flush)
        dense_b = bound(2 * x_bytes + 2 * F_ * kdim + 2 * out_bytes, flops)
        quant_b = bound(2 * x_bytes + packed_bytes + scale_bytes + 4 * F_
                        + 2 * out_bytes, flops)
        int_b = bound(x_bytes + packed_bytes + 2 * F_ + 4 * out_bytes,
                      flops, INT8_OPS_PER_S)
        row.update({"dense_bound_ms": dense_b[0],
                    "dense_bound_by": dense_b[1],
                    "quant_bound_ms": quant_b[0],
                    "quant_bound_by": quant_b[1],
                    "int_bound_ms": int_b[0], "int_bound_by": int_b[1]})
        W, Sc, Bi, Wi, Si = (case[k] for k in ("W", "S", "B", "Wi", "Si"))
        patches, pi = case["patches"], case["pi"]
        k1 = case["fused"].matmul.kernel_for(M_)
        k1i = case["int_fused"].matmul.kernel_for(M_)
        read = case["read"]
        k2_b = bound(packed_bytes + scale_bytes + 2 * F_ * kdim, 0)
        k3_b = bound(packed_bytes + F_ * kdim, 0)
        k1_b = bound(2 * M_ * kdim + packed_bytes + scale_bytes + 4 * F_
                     + 2 * out_bytes, flops)
        k1i_b = bound(M_ * kdim + packed_bytes + 2 * F_ + 4 * out_bytes,
                      flops, INT8_OPS_PER_S)
        wdec, cdec = case["wcard"], case["codes_plain"].contiguous()
        krows = [
            ("weight_decode_fmt uint4xfloat16",
             lambda: mz.weight_decode_fmt(W, "uint4", "float16", Sc, None,
                                          CONV_GROUP),
             lambda: mz.weight_decode_fmt_plain(W, "uint4", "float16", Sc,
                                                None, CONV_GROUP),
             None, k2_b, 0.0),
            ("dequant_matmul_fmt tiled uint4xfloat16",
             lambda: k1(patches, W, Sc, Bi),
             lambda: dq.dequant_matmul_fmt_plain(patches, W, "uint4", Sc,
                                                 None, CONV_GROUP, bias=Bi),
             lambda: torch.matmul(patches, wdec.T), k1_b,
             read["fused_max_abs_err"]),
            ("weight_decode_int8 uint4",
             lambda: mz.weight_decode_int8(Wi, 4, "uint"),
             lambda: mz.weight_decode_int8_plain(Wi, 4, "uint"), None,
             k3_b, 0.0),
            ("dequant_matmul_int tiled uint4xint8",
             lambda: k1i(pi, Wi, Si, None),
             lambda: dq.dequant_matmul_int_plain(pi, Wi, "uint4", Si, None,
                                                 -1),
             lambda: torch._int_mm(pi, cdec.T), k1i_b,
             read["int_fused_max_abs_err"])]
        for name, fn, plain, lib, (b_ms, b_by), err in krows:
            rows["kernels"].append({
                "name": name, "shape": case["shape"], "M": M_, "N": F_,
                "K": kdim, "kernel_ms": time_ms(torch, fn, 20, flush),
                "plain_ms": time_ms(torch, plain, 20, flush),
                "library_ms": (None if lib is None
                               else time_ms(torch, lib, 20, flush)),
                "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err})
        k2_ms = rows["kernels"][-4]["kernel_ms"]
        row["kernel2_ms"] = k2_ms
        row["kernel2_share_of_materialize"] = k2_ms / row["materialize_ms"]
        row["kernel3_share_of_int_materialize"] = \
            rows["kernels"][-2]["kernel_ms"] / row["int_materialize_ms"]
        rows["conv"].append(row)
        emit({"phase": "ops_conv", **row})
    for i, case in enumerate(splitk):
        W, S, Z = case["packed"]
        for m, A in case["A"].items():
            mm_ms = time_ms(torch, lambda: case["full"](A, W, scale=S,
                                                        zeros=Z), 20, flush)
            for ks, (op, (Ws, Ss, Zs)) in case["split"].items():
                r_ = next(r for r in rows["splitk"] if (
                    r["N"], r["K"], r["M"], r["k_split"])
                    == (case["N"], case["K"], m, ks))
                r_.update({
                    "splitk_ms": time_ms(torch, lambda: op(
                        A, Ws, scale=Ss, zeros=Zs), 20, flush),
                    "matmul_ms": mm_ms, "launches_per_call": ks,
                    "matmul_launches_per_call": 1})
    emit({"phase": "ops_splitk", "rows": rows["splitk"]})
    # kernel 1's decode instance at a split-K shard (M = 4, 11008 x 2048),
    # the kernels line's row of the ops phase's dequant_matmul_u4 launches
    case = splitk[1]
    op, (Ws, Ss, Zs) = case["split"][2]
    A = case["A"][4][:, :op.shard_k].contiguous()
    gk = op.shard_k // CONV_GROUP
    sargs = (A, Ws[0], Ss[:gk], Zs[:gk])
    got = dq.dequant_matmul_u4(*sargs, tile=dq.U4_DECODE_TILE)
    ref = dq.dequant_matmul_u4_split_plain(*sargs)
    wdec = dq.dequantize_hopper(Ws[0], Ss[:gk], Zs[:gk])
    Nn, Kk = case["N"], op.shard_k
    b_ms, b_by = bound(2 * 4 * Kk + Nn * Kk // 2 + 4 * Nn * Kk // CONV_GROUP
                       + 2 * 4 * Nn, 2 * 4 * Nn * Kk)
    rows["shard"] = {
        "name": "dequant_matmul_u4", "M": 4, "N": Nn, "K": Kk,
        "ulps": f16_ulps(torch, got, ref),
        "max_abs_err": (got.float() - ref.float()).abs().max().item(),
        "kernel_ms": time_ms(torch, lambda: dq.dequant_matmul_u4(
            *sargs, tile=dq.U4_DECODE_TILE), 20, flush),
        "plain_ms": time_ms(torch, lambda: dq.dequant_matmul_u4_plain(
            *sargs), 20, flush),
        "library_ms": time_ms(torch, lambda: torch.matmul(A, wdec.T), 20,
                              flush),
        "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "ops_kernels", "rows": rows["kernels"],
          "shard": rows["shard"]})
    if not rows["shard"]["ulps"] <= 1.0:
        raise AssertionError(f"ops: split-K shard: {rows['shard']}")
    for dtype, (op, a, w) in bmm.items():
        r_ = next(r for r in rows["bmm"] if r["dtype"] == dtype)
        isz = 1 if dtype == "int8" else 2
        osz = 4 if dtype == "int8" else 2
        b_ms, b_by = bound(isz * B * (M + N) * K + osz * B * M * N,
                           2 * B * M * N * K,
                           INT8_OPS_PER_S if dtype == "int8"
                           else F16_FLOPS_PER_S)
        r_.update({"ms": time_ms(torch, lambda: op(a, w), 20, flush),
                   "plain_ms": time_ms(torch, lambda: batch_matmul_plain(
                       a, w, "nt", bouts[dtype].dtype), 20, flush),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "shape": BMM_SHAPE})
    emit({"phase": "ops_bmm", "rows": rows["bmm"]})
    # the chained timer beside measure_kernel on kernel 1's decode instance
    case = splitk[1]
    W, S, Z = case["packed"]
    A4 = case["A"][4]

    def decode():
        return dq.dequant_matmul_u4(A4, W, S, Z, tile=dq.U4_DECODE_TILE)

    rows["chained"] = {
        "M": 4, "N": case["N"], "K": case["K"],
        "chained_ms": measure_chained(make_chained(decode, ())) * 1e3,
        "unflushed_ms": measure_kernel(decode, (), flush=False) * 1e3,
        "flushed_ms": time_ms(torch, decode, 20, True)}
    emit({"phase": "ops_chained", **rows["chained"],
          "seconds": time.perf_counter() - t0})
    return rows, launches


def ops_entries(rows):
    """The kernels line's entries of the ops phase: kernels 1-3 at the
    first ResNet-50 shape (every shape's rows in `max_abs_err`), kernel 1's
    decode instance at a split-K shard."""
    out = []
    for name, src, rep in (
            ("dequant_matmul_fmt tiled uint4xfloat16", "dequant_wgmma.cuh",
             "dequant_matmul.py:231"),
            ("weight_decode_fmt uint4xfloat16", "dequant_fmt_uint_f16.cu",
             "materialize.py:227"),
            ("dequant_matmul_int tiled uint4xint8", "dequant_wgmma.cuh",
             "dequant_matmul.py:231"),
            ("weight_decode_int8 uint4", "weight_decode_int8.cu",
             "materialize.py:398")):
        krows = [r for r in rows["kernels"] if r["name"] == name]
        r = krows[0]
        out.append((name, src, rep, krows, r,
                    f"ResNet-50 conv {r['shape']} batch {CONV_BATCH}: "
                    f"M={r['M']} N={r['N']} K={r['K']}"))
    s = rows["shard"]
    out.append(("dequant_matmul_u4", "dequant_matmul.cu",
                "dequant_matmul.py:231", [s], s,
                f"split-K shard M=4 N={s['N']} K={s['K']} uint4 g128"))
    return out


def kernel_entry(name, src, rep, rows, row, shape, launches) -> dict:
    """One kernel of the `kernels` line: its launches on the main path,
    the worst error of its rows, the times and bound of its row."""
    return {
        "name": name, "route": "cuda",
        "source": f"bitblas_tpu_torch/csrc/{src}",
        "replaces": f"bitblas_tpu/kernels/{rep}",
        "launches": launches.get(name, 0),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"], "shape": shape,
        **{k: row[k] for k in ("gather_ms", "stream_ms", "tile_32x64_ms",
                               "tile_ms") if k in row}}


# kernel 4's configurations in the kernels line: (D, causal, layout,
# operand type, Out_dtype), each at S = 2048 (D = 100 at 512 too)
FA_SUMMARY = ((100, True, "nnn", "float16", "float16"),
              (64, True, "nnn", "float16", "float16"),
              (80, True, "nnn", "float16", "float16"),
              (160, True, "nnn", "float16", "float16"),
              (96, True, "nnn", "float16", "float16"),
              (256, True, "nnn", "float16", "float16"),
              (128, False, "nnn", "float16", "float16"),
              (128, True, "ntn", "float16", "float16"),
              (100, False, "ntn", "bfloat16", "bfloat16"),
              (128, True, "nnn", "float32", "float32"),
              (128, True, "nnn", "float16", "float32"))


def prefill_source(instance: str, D: int) -> str:
    """The csrc source of kernel 4's `instance` at head dim D (the aligned
    route runs a wgmma instance behind kernels/flash.py's layout pass)."""
    if instance in ("general", "f32"):
        return f"flash_attention_{instance}.cu"
    return "flash_attention.cu" if D == 128 else f"flash_attention_d{D}.cu"


def flash_summary(fa_rows):
    """The kernels line's rows of kernel 4's configurations, named by the
    launch variant their default tile counts under."""
    import torch
    from bitblas_tpu_torch.kernels.flash import (prefill_instance,
                                                 prefill_variant)
    out = []
    for D, causal, layout, dtype, o in FA_SUMMARY:
        rows = [r for r in fa_rows if (r["D"], r["causal"], r["layout"],
                                       r["dtype"], r["out"])
                == (D, causal, layout, dtype, o)]
        row = next(r for r in rows if r["S"] == 2048)
        instance = prefill_instance(2048, FA_HEADS, FA_HEADS, D,
                                    getattr(torch, dtype),
                                    trans_k=layout == "ntn")
        name = "flash_attention_fwd " + prefill_variant(
            getattr(torch, dtype), D, causal=causal,
            trans_k=layout == "ntn", out_dtype=getattr(torch, o),
            block_kv=row["tile"][1], instance=instance)
        src = prefill_source(instance, D)
        out.append((name, src, "flash.py:106", rows, row,
                    f"B=1 H=Hkv=32 S=2048 D={D} {layout} "
                    f"{'causal' if causal else 'dense'} {dtype} -> {o}"))
    return out


def flashatten_counts(fa_rows, fa_launches):
    """{kernels-line name: {"flashatten_launches": n}} for kernel 4's
    configuration rows: the flashatten phase's launches of that variant,
    kept apart from the serve phases' `launches`."""
    prefix = "flash_attention_fwd "
    return {e[0]: {"flashatten_launches": fa_launches.get(
        e[0][len(prefix):], 0)} for e in flash_summary(fa_rows)}


def pick(rows, **where):
    """The first row whose fields hold the given values."""
    return next(r for r in rows if all(r[k] == v for k, v in where.items()))


def llama_entries(dq, wd_u4, fa, fd):
    """The kernels line's entries of the uint4 Llama path (kernel 1's
    decode and tiled uint4 instances, kernel 2, kernels 4 and 5), each
    with its rows of the kernels phase: `--quantize`'s line, and the first
    entries of the full run's."""
    return [
        ("dequant_matmul_u4", "dequant_matmul.cu", "dequant_matmul.py:231",
         [r for r in dq if r["M"] <= 16], pick(dq, M=4, N=11008, K=4096),
         "M=4 N=11008 K=4096"),
        (TILED["uint4"], "dequant_wgmma.cuh", "dequant_matmul.py:231",
         [r for r in dq if r["M"] > 16], pick(dq, M=256, N=11008, K=4096),
         "M=256 N=11008 K=4096 uint4 x f16, 64 x 128 tile"),
        ("weight_decode_u4", "weight_decode.cu", "materialize.py:227",
         wd_u4, pick(wd_u4, N=11008, K=4096), "N=11008 K=4096 uint4 -> f16"),
        ("flash_attention_fwd", "flash_attention.cu", "flash.py:106",
         fa, pick(fa, S=512, Hkv=32), "B=1 H=32 S=512 D=128 causal"),
        ("flash_decode", "flash_decode.cu", "flash.py:456", fd,
         pick(fd, Hkv=32), "B=4 H=32 Smax=1024 lengths 1/37/513/1024"),
    ]


# -- multi-GPU: tensor / expert / pipeline / context parallelism (slice 17) --
#
# One card cannot hold two NCCL ranks, so the sharded path is driven in
# two ways: a world of two ranks on the one card over gloo (which carries
# CUDA tensors through the host: the sharded arithmetic with the real
# kernels at rank-local shapes; its collective times are no scaling
# figure), and the main process as a one-rank NCCL group (the backend a
# multi-card run takes). The world starts once and runs serve_tp,
# tp_options and ep_mixtral; the parent runs partial_stats, tp_nccl,
# pipeline and dp_group. gloo refuses batch_isend_irecv on CUDA tensors
# (the probe's line), so the pipeline runs at pp = 1 under NCCL here; its
# two-stage schedule is held on the CPU (tests/test_torch_pipeline.py).

# meta-llama/Meta-Llama-3-70B config.json: hidden 8192, intermediate
# 28672, 64 heads, 8 KV heads, vocab 128256, rope_theta 500000; GPTQ W4A16
# g128 with original zeros (serve's layout)
LLAMA3_70B_HF = dict(hidden_size=8192, intermediate_size=28672,
                     num_attention_heads=64, num_key_value_heads=8,
                     vocab_size=128256, rope_theta=500000.0,
                     rms_norm_eps=1e-5, num_hidden_layers=80)
TP_LAYERS = 16                # 80 -> 16: two ranks' sources, shards and
#                               caches near 30 GB on one card
TP_PROMPTS = (200, 300, 450, 500)
TP_SEED = 70
# the rank-local (N, K) of kernel 1 at tp 2: fused q/k/v (32 + 2 * 4 heads
# of 128), o (K = 4096), fused gate/up (2 * 14336), down (K = 14336)
TP_SHAPES = ((5120, 8192), (8192, 4096), (28672, 8192), (8192, 14336))
# serve_tp's limits against the single-device model on the same weights,
# in float16 ulps of the largest |value| (the hidden state after layer 1;
# the prompts' first-token logits after 16 layers). Each row-parallel
# product is rounded to f16 on each rank and the two partials summed in
# f32, where the single-device kernel rounds the whole sum once: about
# one ulp a projection, two projections a layer. The first reading on
# an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): 2.0 ulps after layer 1,
# 0.39 on the logits (the final norm and the f32 head shrink the hidden
# states' difference); the limits hold twice and ten times those.
TP_HIDDEN_ULPS = 4.0
TP_LOGIT_ULPS = 4.0
# the partial_stats phase (kernels 5 and 6 over two sequence shards)
PARTIAL_LENGTHS = (1, 37, 4097, 8000)
PARTIAL_SHAPE = dict(B=4, H=32, Hkv=4, D=128, Smax=8192)
PIPE_N, PIPE_M, PIPE_MICRO, PIPE_LAYERS = 8192, 16, 8, 4
EP_LAYERS = 2                 # Mixtral-8x7B 32 -> 2 (one card holds both
#                               ranks' sources)


def llama3_70b(num_layers: int, **kw):
    from bitblas_tpu_torch.models.quant_llama import LlamaConfig
    hf = LLAMA3_70B_HF
    return LlamaConfig(hidden_size=hf["hidden_size"],
                       intermediate_size=hf["intermediate_size"],
                       num_heads=hf["num_attention_heads"],
                       num_kv_heads=kw.pop("num_kv_heads",
                                           hf["num_key_value_heads"]),
                       num_layers=num_layers, vocab_size=hf["vocab_size"],
                       group_size=128, rope_theta=hf["rope_theta"],
                       rms_norm_eps=hf["rms_norm_eps"], **kw)


def all_counters():
    """Every kernel wrapper's launch counter (`launches`)."""
    from bitblas_tpu_torch.kernels import dense, flash, materialize
    from bitblas_tpu_torch.kernels.dequant_matmul import (
        dequant_matmul_fmt, dequant_matmul_i2, dequant_matmul_u4)
    return (dequant_matmul_u4, dequant_matmul_i2,
            materialize.weight_decode_u4, materialize.weight_decode_int8,
            flash.flash_attention_fwd, flash.flash_decode,
            flash.flash_decode_quant, flash.flash_decode_paged,
            flash.flash_decode_paged_quant, dense.dense_matmul,
            dequant_matmul_fmt, materialize.weight_decode_fmt,
            flash.flash_decode_partial, flash.flash_decode_quant_partial)


def _reset(counters):
    for c in counters:
        c.launches = 0
        if hasattr(c, "variant_launches"):
            c.variant_launches.clear()


def f16_ulp_of(x: float) -> float:
    """One float16 ulp at |x| (the smallest normal's below it)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -14))) - 10)


def _ulps(torch, got, want) -> float:
    """max |got - want| in float16 ulps of the largest |want|."""
    err = (got.float() - want.float()).abs().max().item()
    return err / f16_ulp_of(want.float().abs().max().item())


def check_partial_stats(torch, flush):
    """Kernels 5 and 6 in partial_stats mode over two sequence shards of a
    slot cache (B = 4, H = 32, Hkv = 4, D = 128, Smax = 8192 cut at 4096;
    lengths 1 / 37 / 4097 / 8000: the second shard empty for the first
    two), each against its plain version (m to 1e-3 absolute, acc and l to
    1e-4 of their largest value: the same f32 arithmetic regrouped by
    split); the log-sum-exp merge of the two shards against the unsplit
    kernel's output (2e-3: one f16 rounding of |out| < 2). Times on shard
    0 (the most live keys); the bound counts its live keys, the library
    call is SDPA over the shard."""
    from bitblas_tpu_torch.kernels import flash
    from bitblas_tpu_torch.serving.kv_cache import quantize_kv
    F = torch.nn.functional
    p = PARTIAL_SHAPE
    B, H, Hkv, D, Smax = p["B"], p["H"], p["Hkv"], p["D"], p["Smax"]
    half, rows_n = Smax // 2, 6
    gen = torch.Generator(device="cuda")
    gen.manual_seed(33)
    lengths = torch.tensor(PARTIAL_LENGTHS, dtype=torch.int32, device="cuda")
    slots = torch.tensor([5, 0, 3, 1], dtype=torch.int32, device="cuda")
    q = torch.randn((B, H, D), generator=gen, device="cuda").half()
    kf, vf = (torch.randn((rows_n, Smax, Hkv, D), generator=gen,
                          device="cuda") for _ in range(2))
    out_rows = []
    for quant in (False, True):
        if quant:
            (kc, ks), (vc, vs) = quantize_kv(kf), quantize_kv(vf)
            caches = (kc, vc, ks, vs)
            kernel, name = flash.flash_decode_quant, \
                "flash_decode_quant_partial"
            per_key = Hkv * (2 * D + 2 * 4)
            kd, vd = kc.float() * ks[..., None], vc.float() * vs[..., None]
        else:
            caches = (kf.to(torch.bfloat16), vf.to(torch.bfloat16))
            kernel, name = flash.flash_decode, "flash_decode_partial"
            per_key = Hkv * D * 2 * 2
            kd, vd = caches
        shards = []
        for c in range(2):
            part = tuple(t[:, c * half:(c + 1) * half].contiguous()
                         for t in caches)
            lloc = (lengths - c * half).clamp(0, half).to(torch.int32)
            got = kernel(q, *part[:2], *part[2:], lloc, slots,
                         partial_stats=True)
            want = flash.flash_decode_partial_plain(q, *part[:2], lloc, slots,
                                                    *part[2:])
            torch.cuda.synchronize()
            errs = {}
            for key, g, w, tol in (("m", got[1], want[1], None),
                                   ("l", got[2], want[2], 1e-4),
                                   ("acc", got[0], want[0], 1e-4)):
                e = (g - w).abs().max().item()
                lim = 1e-3 if tol is None else tol * w.abs().max().item()
                if not (e <= lim and torch.isfinite(g).all().item()):
                    raise AssertionError(f"{name} shard {c}: {key} max abs "
                                         f"err {e} > {lim}")
                errs[key] = e
            empty = lloc == 0
            m_empty = torch.tensor(flash.EMPTY_M, device="cuda") * flash.LN2
            if empty.any() and not bool(
                    (got[1][empty] == m_empty).all()
                    and (got[2][empty] == 0).all()):
                raise AssertionError(f"{name} shard {c}: an empty shard's "
                                     f"m / l are not -1e30 ln 2 / 0")
            shards.append((part, lloc, got, errs))
        m_g = torch.maximum(shards[0][2][1], shards[1][2][1])
        w = [torch.exp(s[2][1] - m_g) for s in shards]
        acc = sum(wi[..., None] * s[2][0] for wi, s in zip(w, shards))
        l = sum(wi * s[2][2] for wi, s in zip(w, shards))
        merged = (acc / l.clamp_min(1e-30)[..., None]).half()
        whole = kernel(q, *caches[:2], *caches[2:], lengths, slots)
        merge_err = (merged.float() - whole.float()).abs().max().item()
        if not merge_err <= 2e-3:
            raise AssertionError(f"{name}: the two shards' merge is "
                                 f"{merge_err} from the unsplit kernel")
        part, lloc, _, errs = shards[0]
        args = (q, *part[:2], *part[2:], lloc, slots)
        live = int(lloc.sum().item())
        nbytes = live * per_key + B * H * D * 2 + B * H * (D + 2) * 4
        b_ms, b_by = bound(nbytes, 4.0 * live * H * D)
        s = slots.long()
        kg, vg = (x[:, :half][s].float().transpose(1, 2).half()
                  .repeat_interleave(H // Hkv, dim=1) for x in (kd, vd))
        mask = (torch.arange(half, device="cuda")[None]
                < lloc[:, None].long())[:, None, None, :]
        row = {"phase": "partial_stats", "kernel": name, "B": B, "H": H,
               "Hkv": Hkv, "D": D, "Smax": Smax, "shard_rows": half,
               "lengths": list(PARTIAL_LENGTHS),
               "shard0_lengths": lloc.tolist(),
               "max_abs_err": max(max(s[3].values()) for s in shards),
               "errors": [s[3] for s in shards], "merge_err": merge_err,
               "kernel_ms": time_ms(torch, lambda: kernel(
                   *args[:-2], args[-2], args[-1], partial_stats=True), 20,
                   flush),
               # the same walk ending in the division (normalised out)
               "normal_ms": time_ms(torch, lambda: kernel(*args), 20, flush),
               "plain_ms": time_ms(torch, lambda: flash
                                   .flash_decode_partial_plain(
                                       q, *part[:2], lloc, slots, *part[2:]),
                                   5, flush),
               "library_ms": time_ms(torch, lambda: F
                                     .scaled_dot_product_attention(
                                         q[:, :, None], kg, vg,
                                         attn_mask=mask), 20, flush),
               "stream_ms": time_ms(torch, _stream(torch, nbytes), 20, flush),
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        out_rows.append(row)
    return out_rows


def check_tp_kernels(torch, flush):
    """Kernels 1, 2, 4 and 5 at serve_tp's rank-local shapes (Llama-3-70B
    at tp 2): kernel 1 at the four projections' (N, K) (TP_SHAPES), M = 4
    (decode instance) and 256 (tiled); kernel 2 at each of them (the
    materialize plan of the 512-token prefill bucket), bit for bit;
    kernel 4 over a rank's heads (32 q, 4 KV, S = 512) and kernel 5 (B =
    4, Smax = 1024)."""
    from bitblas_tpu_torch.kernels import flash
    from bitblas_tpu_torch.kernels.materialize import (weight_decode_u4,
                                                       weight_decode_u4_plain)
    F = torch.nn.functional
    dq = check_dequant(torch, flush, shapes=TP_SHAPES, ms=(4, 256), seed=17,
                       extra={"tp": 2})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    wd = []
    for (N, K) in TP_SHAPES:
        G = K // 128
        qw = _words(torch, gen, (N, K // 8))
        sc = (torch.rand((G, N), generator=gen, device="cuda") * 0.01
              + 0.005).half()
        zr = torch.randint(0, 16, (G, N), generator=gen, device="cuda").half()
        nbytes = N * K / 2 + 2 * G * N * 2 + N * K * 2
        b_ms, b_by = bound(nbytes, 0.0)
        wd.append(_exact_row(
            torch, "weight_decode_u4", weight_decode_u4(qw, sc, zr),
            weight_decode_u4_plain(qw, sc, zr),
            {"N": N, "K": K, "tp": 2, "out": "float16", "bound_ms": b_ms,
             "bound_by": b_by},
            {"kernel_ms": (lambda: weight_decode_u4(qw, sc, zr), 10),
             "plain_ms": (lambda: weight_decode_u4_plain(qw, sc, zr), 2),
             "library_ms": (None, 0),
             "stream_ms": (_stream(torch, nbytes), 10)}, flush))
    B, H, Hkv, D, S = 1, 32, 4, 128, 512
    Q = torch.randn((B, S, H, D), generator=gen, device="cuda").half()
    K_, V_ = (torch.randn((B, S, Hkv, D), generator=gen,
                          device="cuda").half() for _ in range(2))
    out = flash.flash_attention_fwd(Q, K_, V_)
    ref = flash.flash_attention_plain(Q, K_, V_)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not (err <= 1e-2 and torch.isfinite(out).all().item()):
        raise AssertionError(f"flash tp2: max abs err {err} > 1e-2")
    qt = Q.transpose(1, 2).contiguous()
    kt, vt = (x.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
              .contiguous() for x in (K_, V_))
    nbytes = 2 * B * S * (H + Hkv) * D * 2
    b_ms, b_by = bound(nbytes, 4.0 * B * H * D * S * (S + 1) / 2)
    fa = {"phase": "kernels", "kernel": "flash_attention_fwd", "tp": 2,
          "B": B, "H": H, "Hkv": Hkv, "S": S, "D": D, "max_abs_err": err,
          "tol": 1e-2,
          "kernel_ms": time_ms(torch, lambda: flash.flash_attention_fwd(
              Q, K_, V_), 20, flush),
          "plain_ms": time_ms(torch, lambda: flash.flash_attention_plain(
              Q, K_, V_), 5, flush),
          "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
              qt, kt, vt, is_causal=True), 20, flush),
          "stream_ms": time_ms(torch, _stream(torch, nbytes), 20, flush),
          "bound_ms": b_ms, "bound_by": b_by}
    emit(fa)
    Bd, Smax = 4, 1024
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    slots = torch.tensor([5, 0, 3, 1], dtype=torch.int32, device="cuda")
    q = torch.randn((Bd, H, D), generator=gen, device="cuda").half()
    kc, vc = (torch.randn((6, Smax, Hkv, D), generator=gen,
                          device="cuda").to(torch.bfloat16)
              for _ in range(2))
    args = (q, kc, vc, lengths, slots)
    kg, vg = (x[slots.long()].transpose(1, 2).half()
              .repeat_interleave(H // Hkv, dim=1) for x in (kc, vc))
    mask = (torch.arange(Smax, device="cuda")[None] < lengths[:, None]
            .long())[:, None, None, :]
    ltot = int(lengths.sum().item())
    nbytes = ltot * Hkv * D * 2 * 2 + 2 * Bd * H * D * 2
    b_ms, b_by = bound(nbytes, 4.0 * ltot * H * D)
    fd = _decode_row(
        torch, "flash_decode", flash.flash_decode(*args),
        flash.flash_decode_plain(*args), 2e-3,
        {"kernel_ms": (lambda: flash.flash_decode(*args), 20),
         "plain_ms": (lambda: flash.flash_decode_plain(*args), 5),
         "library_ms": (lambda: F.scaled_dot_product_attention(
             q[:, :, None], kg, vg, attn_mask=mask), 20),
         "stream_ms": (_stream(torch, nbytes), 20)},
        {"tp": 2, "B": Bd, "H": H, "Hkv": Hkv, "Smax": Smax,
         "lengths": lengths.tolist(), "bound_ms": b_ms, "bound_by": b_by},
        flush)
    return dq, wd, fa, fd


def tp_serving_model(torch, num_layers: int = TP_LAYERS, seed: int = TP_SEED,
                     **kw):
    """The single-device source (Llama-3-70B widths at `num_layers`,
    drawn on the card from `seed`: the same weights in every process), its
    LMHead and serve_tp's token prompts."""
    import numpy as np
    from bitblas_tpu_torch.models.hf_import import LMHead
    from bitblas_tpu_torch.models.quant_llama import QuantLlama
    t0 = time.perf_counter()
    cfg = llama3_70b(num_layers, **kw)
    model = QuantLlama(cfg, device="cuda", seed=seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    V, Hd = cfg.vocab_size, cfg.hidden_size
    head = LMHead(
        embed=(torch.randn((V, Hd), generator=gen, device="cuda") * 0.05
               ).half(),
        final_norm=torch.ones(Hd, device="cuda"),
        lm_head=torch.randn((V, Hd), generator=gen, device="cuda") * 0.05,
        norm_eps=cfg.rms_norm_eps, device="cuda")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, V, n).astype(np.int32) for n in TP_PROMPTS]
    packed = sum(t.numel() * t.element_size()
                 for n, t in model.named_buffers() if "qweight" in n or
                 "scales" in n or "zeros" in n)
    return {"cfg": cfg, "model": model, "head": head, "prompts": prompts,
            "init_s": time.perf_counter() - t0, "weight_bytes": packed,
            "name": f"Llama-3-70B widths, W4A16 g128, {num_layers} layers"}


def _bucket_of(n: int) -> int:
    return 1 << (n - 1).bit_length()


def tp_readings(torch, model, head, prompts, layer1_model=None):
    """What serve_tp holds against the single-device model: the hidden
    state after layer 1 of the first prompt (its prefill through a model
    cut to one layer) and every prompt's first-token logits (the last
    prompt row of a full prefill)."""
    out = {"logits": []}
    for i, p in enumerate(prompts):
        S, bucket = len(p), _bucket_of(len(p))
        x = torch.zeros((1, bucket, head.embed.shape[1]), dtype=torch.float16,
                        device="cuda")
        x[0, :S] = head.embed_tokens(p)
        pos = torch.arange(bucket, device="cuda")[None]
        if i == 0 and layer1_model is not None:
            out["layer1"] = layer1_model.make_prefill(bucket)(x, pos)[0][0, :S]
        h = model.make_prefill(bucket)(x, pos)[0]
        out["logits"].append(head.logits(h[:, S - 1].float())[0])
    out["logits"] = torch.stack(out["logits"])
    torch.cuda.synchronize()
    return out


def _first_layers(model, n: int):
    """A model's first n layers as a model of its own (the same tensors):
    a shallow copy of a TPQuantLlama with its lists cut, or a decoder
    stack over a QuantLlama's first layers."""
    import copy
    import dataclasses
    from bitblas_tpu_torch.models.quant_llama import DecoderServingMixin
    if hasattr(model, "weights"):                  # TPQuantLlama
        m = copy.copy(model)
        m.weights, m.norms = model.weights[:n], model.norms[:n]
        return m
    m = DecoderServingMixin()
    m.cfg = dataclasses.replace(model.cfg, num_layers=n)
    m.layers = list(model.layers[:n])
    return m


def _tokens_sha(reqs) -> str:
    import hashlib
    return hashlib.sha1(json.dumps([list(map(int, r.out_tokens))
                                    for r in reqs]).encode()).hexdigest()


def _quiet_rank(rank: int):
    if rank:
        sys.stdout = open(os.devnull, "w")


def rank_serve_tp(torch, rank, counters):
    """serve_tp on this rank: rank 0 first reads the single-device model
    (tp_readings), then both shard it (TPQuantLlama over the world) and
    serve the four requests through the token engine (serve(), the launch
    counters reset just before and read just after); the same readings of
    the sharded model; one decode step's all-reduces."""
    import torch.distributed as dist
    from bitblas_tpu_torch.parallel.serving import TPQuantLlama
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    ctx = tp_serving_model(torch)
    src = ctx["model"]
    lap("build")
    ref = tp_readings(torch, src, ctx["head"], ctx["prompts"],
                      _first_layers(src, 1)) if rank == 0 else None
    dist.barrier()
    lap("single_device_readings")
    t0 = time.perf_counter()
    tpm = TPQuantLlama(src, None)
    del src
    ctx["model"] = tpm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    shard_s = time.perf_counter() - t0
    got = tp_readings(torch, tpm, ctx["head"], ctx["prompts"],
                      _first_layers(tpm, 1))
    lap("shard_and_tp_readings")
    tpm.collective_s, tpm.collectives, tpm.allreduces = 0.0, 0, 0
    row = serve(torch, {**ctx, "max_seq_len": 1024, "stats": lambda: {
        "collective_s": tpm.collective_s, "collectives": tpm.collectives,
        "allreduces": tpm.allreduces}}, counters, "serve_tp", "token", {},
        LLAMA + ("flash_decode",), profile=False)
    serve_coll = (row["collective_s"], row["collectives"], row["allreduces"])
    lap("serve")
    # one decode step on its own: its all-reduces
    L, kvl, D = tpm.cfg.num_layers, tpm.kvl, tpm.cfg.head_dim
    ck = torch.zeros((L, 4, 64, kvl, D), dtype=torch.bfloat16, device="cuda")
    before, before_s = tpm.allreduces, tpm.collective_s
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tpm.decode_step(torch.zeros((4, 1, tpm.cfg.hidden_size),
                                dtype=torch.float16, device="cuda"), ck,
                    torch.zeros_like(ck),
                    torch.arange(4, dtype=torch.int32, device="cuda"),
                    torch.full((4,), 3, dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    per_step = tpm.allreduces - before
    out = {"row": row, "shard_s": shard_s, "allreduces_per_step": per_step,
           "step_collective_s": tpm.collective_s - before_s,
           "step_s": time.perf_counter() - t0, "laps": laps,
           "collective_s": serve_coll[0], "collectives": serve_coll[1],
           "serve_allreduces": serve_coll[2],
           "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "logits": got["logits"].cpu(), "layer1": got["layer1"].cpu()}
    if ref is not None:
        out["ref_logits"] = ref["logits"].cpu()
        out["ref_layer1"] = ref["layer1"].cpu()
    del ctx, tpm
    torch.cuda.empty_cache()
    return out


def _global_caches(torch, cfg, B, S, seed, scale=1.0):
    """Seeded random float caches [L, B, S, Hkv, D] over the source KV
    heads (the same on every rank)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape = (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.head_dim)
    return tuple((scale * torch.randn(shape, generator=gen, device="cuda"))
                 .to(torch.bfloat16) for _ in range(2))


def _rank_part(tpm, t):
    """This rank's share of a source-head cache tensor (testing/ranks's
    _rank_cache, on the card)."""
    if tpm.context_parallel:
        h = t.shape[3] * tpm.cp // tpm.tp
        a = tpm.rank // tpm.cp
        rows = t.shape[2] // tpm.cp
        return t[:, :, tpm.cp_index * rows:(tpm.cp_index + 1) * rows,
                 a * h:(a + 1) * h].contiguous()
    t = t.repeat_interleave(tpm.kv_rep, dim=3)
    n = t.shape[3] // tpm.tp
    return t[:, :, :, tpm.rank * n:(tpm.rank + 1) * n].contiguous()


def _rel(torch, a, b) -> float:
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-6)).item()


def _within(torch, got, want, rtol, atol, ratio=0.0):
    """The share of |got - want| > atol + rtol |want| within `ratio`."""
    bad = ((got.float() - want.float()).abs()
           > atol + rtol * want.float().abs()).float().mean().item()
    return bad <= ratio


def rank_tp_options(torch, rank, counters):
    """tp_options on this rank, at Llama-3-70B widths cut to 2 layers:
    quantized_collectives and overlap_chunks=2 against the exact
    all-reduce, decode_step_quant against the float cache, the paged
    engine against the slot engine, and (1 KV head: kv_rep 2) context
    parallelism against the single-device model through kernels 5 and 6
    in partial_stats mode; each at JAX's limits (tests/test_tp_serving.py:
    139-552; the int8 cache's relative one)."""
    import numpy as np
    from bitblas_tpu_torch.parallel.serving import TPQuantLlama
    from bitblas_tpu_torch.serving.engine import (
        ContinuousBatchingEngine, PagedContinuousBatchingEngine, Request)
    from bitblas_tpu_torch.serving.kv_cache import quantize_kv
    res = {}
    B, S = 4, 64
    slots = torch.arange(B, dtype=torch.int32, device="cuda")
    lengths = torch.tensor([3, 17, 40, 63], dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(71)
    ctx = tp_serving_model(torch, 2, seed=72)
    src, cfg = ctx["model"], ctx["cfg"]
    x = torch.randn((B, 1, cfg.hidden_size), generator=gen,
                    device="cuda").half()
    ck, cv = _global_caches(torch, cfg, B, S, 73)
    y_ref = src.decode_step(x, ck.clone(), cv.clone(), slots, lengths)[0]
    models = {"exact": TPQuantLlama(src, None),
              "int8_collectives": TPQuantLlama(src, None,
                                               quantized_collectives=True),
              "overlap2": TPQuantLlama(src, None, overlap_chunks=2)}
    ys = {}
    for name, tpm in models.items():
        ys[name] = tpm.decode_step(x, _rank_part(tpm, ck),
                                   _rank_part(tpm, cv), slots, lengths)[0]
    tpm = models["exact"]
    res["exact_vs_single"] = _rel(torch, ys["exact"], y_ref)
    res["int8_collectives_rel"] = _rel(torch, ys["int8_collectives"],
                                       ys["exact"])
    res["overlap2_vs_single"] = _rel(torch, ys["overlap2"], y_ref)
    checks = {
        "exact_vs_single": _within(torch, ys["exact"], y_ref, 2e-2, 2e-2),
        "int8_collectives": res["int8_collectives_rel"] < 0.05,
        "overlap2": _within(torch, ys["overlap2"], y_ref, 2e-2, 2e-2)}
    # int8 KV: the same caches quantized, against the float TP step
    kq, ks = quantize_kv(ck.float())
    vq, vs = quantize_kv(cv.float())
    y_q = tpm.decode_step_quant(x, *(_rank_part(tpm, t)
                                     for t in (kq, vq, ks, vs)),
                                slots, lengths)[0]
    # JAX's limit for an int8 cache against the float one, relative to
    # the largest output (tests/test_tp_serving.py:230-287): its absolute
    # form (:479-520, atol 0.3) was set at hidden 256, where the hidden
    # states are far smaller than these 70B-width layers' (~30)
    res["int8_kv_vs_float"] = _rel(torch, y_q, ys["exact"])
    checks["int8_kv"] = res["int8_kv_vs_float"] < 0.06
    # the paged engine against the slot engine (hidden-state requests)
    rng = np.random.default_rng(74)
    prompts = [rng.standard_normal((n, cfg.hidden_size)).astype(np.float16)
               for n in (40, 100, 7)]
    finals = {}
    for kind in ("slot", "paged"):
        eng = PagedContinuousBatchingEngine(
            tpm, num_slots=4, num_blocks=64, block_size=16) \
            if kind == "paged" else ContinuousBatchingEngine(
                tpm, num_slots=4, max_seq_len=256)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p.copy(), max_new=4))
        done = eng.run_to_completion()
        finals[kind] = {r.uid: torch.as_tensor(r.final_hidden)
                        for r in done}
    res["paged_vs_slot"] = max(_rel(torch, finals["paged"][u],
                                    finals["slot"][u]) for u in finals["slot"])
    checks["paged_vs_slot"] = all(
        _within(torch, finals["paged"][u], finals["slot"][u], 5e-2, 5e-2,
                0.02) for u in finals["slot"])
    del models, tpm, src, ctx
    torch.cuda.empty_cache()
    # context parallelism: 1 KV head over 2 ranks (cp = 2), peaked K
    ctx = tp_serving_model(torch, 2, seed=75, num_kv_heads=1)
    src, cfg = ctx["model"], ctx["cfg"]
    ck, cv = _global_caches(torch, cfg, B, S, 76)
    ck = (ck.float() * 20).to(torch.bfloat16)
    y_ref = src.decode_step(x, ck.clone(), cv.clone(), slots, lengths)[0]
    kq, ks = quantize_kv(ck.float())
    vq, vs = quantize_kv(cv.float())
    yq_ref = src.decode_step_quant(x, kq.clone(), vq.clone(), ks.clone(),
                                   vs.clone(), slots, lengths)[0]
    _reset(counters)
    cpm = TPQuantLlama(src, None, context_parallel=True)
    y_cp = cpm.decode_step(x, _rank_part(cpm, ck), _rank_part(cpm, cv),
                           slots, lengths)[0]
    y_cpq = cpm.decode_step_quant(x, *(_rank_part(cpm, t)
                                       for t in (kq, vq, ks, vs)),
                                  slots, lengths)[0]
    eng = ContinuousBatchingEngine(cpm, num_slots=4, max_seq_len=256)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p.copy(), max_new=4))
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    res["cp_partial_launches"] = {c.__name__: c.launches for c in counters
                                  if c.__name__.endswith("_partial")}
    res["cp_vs_single"] = _rel(torch, y_cp, y_ref)
    res["cp_int8_vs_single_int8"] = _rel(torch, y_cpq, yq_ref)
    checks["cp"] = _within(torch, y_cp, y_ref, 2e-2, 2e-2)
    checks["cp_int8"] = _within(torch, y_cpq, yq_ref, 2e-2, 2e-2)
    checks["cp_engine"] = len(done) == 3 and all(
        np.isfinite(r.final_hidden).all() for r in done)
    res["checks"] = checks
    del cpm, src, ctx, eng
    torch.cuda.empty_cache()
    return res


def rank_ep_mixtral(torch, rank):
    """ep_mixtral: Mixtral-8x7B's widths cut to 2 layers, the same seeded
    weights on both ranks; rank 0 reads the single-device model (a 512-
    token prefill's hidden states, 4 greedy tokens); then
    expert_parallel_mixtral over the world (4 experts a rank) and the
    same readings."""
    import torch.distributed as dist
    from bitblas_tpu_torch.models.hf_import import LMHead, QuantLlamaLM
    from bitblas_tpu_torch.models.quant_moe import QuantMixtral
    from bitblas_tpu_torch.parallel.moe import expert_parallel_mixtral
    cfg = mixtral_8x7b(EP_LAYERS)
    model = QuantMixtral(cfg, device="cuda", seed=80)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(81)
    V, Hd = cfg.vocab_size, cfg.hidden_size
    head = LMHead(
        embed=(torch.randn((V, Hd), generator=gen, device="cuda") * 0.05
               ).half(), final_norm=torch.ones(Hd, device="cuda"),
        lm_head=torch.randn((V, Hd), generator=gen, device="cuda") * 0.05,
        device="cuda")
    lm = QuantLlamaLM(model, head)
    import numpy as np
    prompt = np.random.default_rng(82).integers(0, V, 500).astype(np.int32)
    x = torch.zeros((1, 512, Hd), dtype=torch.float16, device="cuda")
    x[0, :500] = head.embed_tokens(prompt)
    pos = torch.arange(512, device="cuda")[None]

    def read():
        h = model.make_prefill(512)(x, pos)[0][0, :500]
        return h, lm.generate(prompt, max_new_tokens=4)[500:]

    ref = read() if rank == 0 else None
    dist.barrier()
    expert_parallel_mixtral(model, None)
    t0 = time.perf_counter()
    got = read()
    torch.cuda.synchronize()
    out = {"ep_s": time.perf_counter() - t0, "tokens": got[1].tolist(),
           "allreduces": sum(l.moe_ep.allreduces for l in model.layers)}
    if ref is not None:
        out["hidden_err"] = (got[0].float() - ref[0].float()).abs().max() \
            .item()
        out["hidden_max"] = ref[0].float().abs().max().item()
        out["ref_tokens"] = ref[1].tolist()
    del model, lm, head
    torch.cuda.empty_cache()
    return out


def parallel_rank(rank, world_size):
    """The world's rank code (two ranks on the one card over gloo): the
    probe, serve_tp, tp_options, ep_mixtral, in order, every rank in
    step."""
    import torch
    from bitblas_tpu_torch.testing.dist import probe_collectives
    _quiet_rank(rank)
    torch.cuda.set_device(0)
    counters = all_counters()
    laps = {}
    t0 = time.perf_counter()
    # which collectives gloo takes on CUDA tensors (batch_isend_irecv left
    # out: gloo fails it there and can abort the rank from its thread)
    out = {"probe": probe_collectives(rank, world_size, "cuda:0", False)}
    laps["probe"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["serve_tp"] = rank_serve_tp(torch, rank, counters)
    laps["serve_tp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["tp_options"] = rank_tp_options(torch, rank, counters)
    laps["tp_options"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["ep_mixtral"] = rank_ep_mixtral(torch, rank)
    laps["ep_mixtral"] = time.perf_counter() - t0
    out["seconds"] = laps
    return out


def tp_world_phases(torch):
    """serve_tp, tp_options and ep_mixtral in one spawned world of two
    gloo ranks on the card (started once), each held as its docstring
    says; the backend's name on a line before."""
    from bitblas_tpu_torch.testing.dist import run_world
    emit({"phase": "tp_world", "backend": "gloo", "world_size": 2,
          "device": "cuda:0 (both ranks)",
          "note": "gloo carries CUDA tensors through the host: collective "
                  "times are no NVLink scaling figure"})
    t0 = time.perf_counter()
    ranks = run_world(parallel_rank, 2, timeout_s=900)
    wall = time.perf_counter() - t0
    r0, r1 = ranks
    emit({"phase": "probe", "gloo_cuda": r0["probe"],
          "batch_isend_irecv": "not probed: gloo fails it on CUDA tensors "
                               "(writev of a device pointer, 'Bad "
                               "address'), at times aborting the rank"})
    st = r0["serve_tp"]
    hidden_ulps = _ulps(torch, st["layer1"], st["ref_layer1"])
    logit_ulps = _ulps(torch, st["logits"], st["ref_logits"])
    same_tokens = (st["row"]["tokens_sha1"]
                   == r1["serve_tp"]["row"]["tokens_sha1"])
    cfg = llama3_70b(TP_LAYERS)
    row = {"phase": "serve_tp_summary", "model": st["row"]["model"],
           "tp": 2, "backend": "gloo", "layers": TP_LAYERS,
           "reduced": {"layers": "80 -> 16: both ranks' sources, shards "
                                 "and caches on one card"},
           "decode_tok_s": st["row"]["decode_tok_s"],
           "decode_step_ms": st["row"]["decode_step_ms"],
           "prefill_tok_s": st["row"]["prefill_tok_s"],
           "peak_gb_rank": [r["serve_tp"]["peak_gb"] for r in ranks],
           "allreduces_per_decode_step": st["allreduces_per_step"],
           "collective_s": st["collective_s"],
           "collective_calls": st["collectives"],
           "serve_wall_s": st["row"]["wall_s"],
           "collective_share_of_serve": st["collective_s"]
           / st["row"]["wall_s"],
           "one_step_s": st["step_s"],
           "one_step_collective_s": st["step_collective_s"],
           "collective_note": "gloo through the host, not NCCL over NVLink",
           "shard_s": st["shard_s"],
           "layer1_hidden_f16_ulps": hidden_ulps,
           "hidden_ulps_limit": TP_HIDDEN_ULPS,
           "first_token_logit_f16_ulps": logit_ulps,
           "logit_ulps_limit": TP_LOGIT_ULPS,
           "tokens_equal_across_ranks": same_tokens,
           "launches": st["row"]["launches"], "world_wall_s": wall,
           "rank_seconds": r0["seconds"], "serve_tp_laps": st["laps"]}
    emit(row)
    opts = r0["tp_options"]
    emit({"phase": "tp_options", **opts})
    ep = r0["ep_mixtral"]
    ep_row = {"phase": "ep_mixtral", "ep": 2, "layers": EP_LAYERS,
              "experts_per_rank": 4,
              "reduced": {"layers": "32 -> 2"}, **ep,
              "tokens_equal_across_ranks":
                  ep["tokens"] == r1["ep_mixtral"]["tokens"]}
    emit(ep_row)
    failed = [what for what, ok in (
        (f"serve_tp: {st['allreduces_per_step']} all-reduces a decode "
         f"step, not {2 * cfg.num_layers}",
         st["allreduces_per_step"] == 2 * cfg.num_layers),
        ("serve_tp: the ranks sampled different tokens", same_tokens),
        (f"serve_tp: {hidden_ulps} / {logit_ulps} f16 ulps from the "
         f"single-device model", hidden_ulps <= TP_HIDDEN_ULPS
         and logit_ulps <= TP_LOGIT_ULPS),
        (f"tp_options: {opts['checks']}", all(opts["checks"].values())),
        (f"tp_options: the cp run launched no partial_stats kernel: "
         f"{opts['cp_partial_launches']}",
         min(opts["cp_partial_launches"].values()) > 0),
        (f"ep_mixtral: {ep_row}", ep["tokens"] == ep["ref_tokens"]
         and ep_row["tokens_equal_across_ranks"]
         and ep["hidden_err"] <= 1e-2 * ep["hidden_max"]
         and ep["allreduces"] > 0)) if not ok]
    if failed:
        raise AssertionError("; ".join(failed))
    return row, st, opts


def tp_nccl_phase(torch, st):
    """tp_nccl: serve_tp's model (same seed, 16 layers) in this process as
    a one-rank NCCL group: its first-token logits against serve_tp's
    sharded run (the same ulp limit as against the single-device model),
    and four token requests served. Then pipeline at pp = 1 on the same
    group."""
    import torch.distributed as dist
    from bitblas_tpu_torch.parallel.serving import TPQuantLlama
    from bitblas_tpu_torch.serving.engine import TokenContinuousBatchingEngine
    d = tempfile.mkdtemp(prefix="bbt_nccl_")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(d, "store"), 1), rank=0, world_size=1)
    try:
        emit({"phase": "tp_nccl", "backend": dist.get_backend(),
              "world_size": 1})
        t0 = time.perf_counter()
        ctx = tp_serving_model(torch)
        tpm = TPQuantLlama(ctx["model"], None)
        ctx["model"] = None
        torch.cuda.empty_cache()
        got = tp_readings(torch, tpm, ctx["head"], ctx["prompts"])
        ulps = _ulps(torch, got["logits"].cpu(), st["logits"])
        eng = TokenContinuousBatchingEngine(tpm, ctx["head"], num_slots=4,
                                            max_seq_len=1024)
        reqs = [eng.submit_tokens(uid=i, tokens=p, max_new=8)
                for i, p in enumerate(ctx["prompts"])]
        eng.run_to_completion()
        torch.cuda.synchronize()
        row = {"phase": "tp_nccl", "backend": "nccl", "world_size": 1,
               "layers": TP_LAYERS, "first_token_logit_f16_ulps": ulps,
               "limit": TP_LOGIT_ULPS, "allreduces": tpm.allreduces,
               "tokens": [r.out_tokens for r in reqs],
               "seconds": time.perf_counter() - t0}
        emit(row)
        if not (ulps <= TP_LOGIT_ULPS and all(r.done for r in reqs)
                and tpm.allreduces > 0):
            raise AssertionError(f"tp_nccl: {row}")
        del tpm, ctx, eng
        torch.cuda.empty_cache()
        pipe = pipeline_phase(torch)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(d, ignore_errors=True)
    return row, pipe


def pipeline_phase(torch):
    """pipeline: make_gpipe_fn over make_quant_stage_fn on the one-rank
    NCCL group (pp = 1: gloo refuses batch_isend_irecv on CUDA tensors,
    the probe's line), the stage holding both stages' layers (4 uint4 g128
    layers at N = K = 8192), 8 microbatches of M = 16, against the layers
    applied in turn: bit for bit."""
    from bitblas_tpu_torch.ops.matmul_config import MatmulConfig
    from bitblas_tpu_torch.parallel.pipeline import (make_gpipe_fn,
                                                     make_quant_stage_fn,
                                                     stack_stage_params)
    N = PIPE_N
    cfg = MatmulConfig(M=PIPE_M, N=N, K=N, A_dtype="float16",
                       W_dtype="uint4", with_scaling=True, group_size=128,
                       out_dtype="float16")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(90)
    params = {"qweight": _words(torch, gen, (PIPE_LAYERS, N, N // 8)),
              "scales": (torch.rand((PIPE_LAYERS, N // 128, N), generator=gen,
                                    device="cuda") * 2e-4 + 1e-4).half()}
    stage = make_quant_stage_fn(cfg, PIPE_M, PIPE_LAYERS, device="cuda")
    pipe = make_gpipe_fn(stage, None)
    xs = torch.randn((PIPE_MICRO, PIPE_M, N), generator=gen,
                     device="cuda").half()
    t0 = time.perf_counter()
    ys = pipe(stack_stage_params([params], None), xs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ref = torch.stack([stage(params, x) for x in xs])
    row = {"phase": "pipeline", "backend": "nccl", "pp": 1,
           "layers": PIPE_LAYERS, "N": N, "K": N, "microbatches": PIPE_MICRO,
           "M": PIPE_M, "bit_equal": bool(torch.equal(ys, ref)),
           "finite": bool(torch.isfinite(ys).all()), "wall_s": wall,
           "note": "gloo refused batch_isend_irecv on CUDA tensors; the "
                   "2-stage schedule is held on the CPU"}
    emit(row)
    if not (row["bit_equal"] and row["finite"]):
        raise AssertionError(f"pipeline: {row}")
    return row


def dp_group_phase(torch):
    """dp_group: two replica token engines on the one card behind
    DataParallelEngineGroup, over Llama-2-7B's widths at the reference's
    depth (1 layer); the finished tokens equal one engine's run of the
    same requests."""
    import numpy as np
    from bitblas_tpu_torch.models.hf_import import LMHead
    from bitblas_tpu_torch.models.quant_llama import QuantLlama
    from bitblas_tpu_torch.serving.engine import (
        DataParallelEngineGroup, TokenContinuousBatchingEngine)
    cfg = llama2_7b(1)
    model = QuantLlama(cfg, device="cuda", seed=91)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(92)
    V, Hd = cfg.vocab_size, cfg.hidden_size
    head = LMHead(
        embed=(torch.randn((V, Hd), generator=gen, device="cuda") * 0.05
               ).half(), final_norm=torch.ones(Hd, device="cuda"),
        lm_head=torch.randn((V, Hd), generator=gen, device="cuda") * 0.05,
        device="cuda")
    rng = np.random.default_rng(93)
    prompts = [rng.integers(0, V, n).astype(np.int32)
               for n in (200, 300, 450, 500, 120, 60)]

    def engine():
        return TokenContinuousBatchingEngine(model, head, num_slots=4,
                                             max_seq_len=1024)

    solo = engine()
    want = [solo.submit_tokens(uid=i, tokens=p, max_new=8)
            for i, p in enumerate(prompts)]
    solo.run_to_completion()
    t0 = time.perf_counter()
    group = DataParallelEngineGroup([engine(), engine()])
    got = [group.submit_tokens(uid=i, tokens=p, max_new=8)
           for i, p in enumerate(prompts)]
    group.run_to_completion()
    torch.cuda.synchronize()
    row = {"phase": "dp_group", "replicas": 2, "layers": 1,
           "requests": len(prompts),
           "per_replica": [len(e.finished) for e in group.engines],
           "tokens_equal": [g.out_tokens == w.out_tokens
                            for g, w in zip(got, want)],
           "wall_s": time.perf_counter() - t0}
    emit(row)
    if not (all(row["tokens_equal"]) and all(row["per_replica"])):
        raise AssertionError(f"dp_group: {row}")
    del model, head, solo, group
    torch.cuda.empty_cache()
    return row


def parallel_phases(torch, flush):
    """Every phase of slice 17, in order: the kernels at serve_tp's shapes
    and in partial_stats mode, the world (the probe, serve_tp, tp_options,
    ep_mixtral), tp_nccl and pipeline, dp_group. Returns
    (kernels line entries, seconds of each)."""
    laps, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        now = time.perf_counter()
        laps[name] = now - t0
        t0 = now

    dq, wd, fa, fd = check_tp_kernels(torch, flush)
    partial = check_partial_stats(torch, flush)
    lap("tp_kernels_partial_stats")
    summary, st, opts = tp_world_phases(torch)
    lap("tp_world")
    tp_nccl_phase(torch, st)
    lap("tp_nccl_pipeline")
    dp_group_phase(torch)
    lap("dp_group")
    launches = dict(summary["launches"])
    launches.update(opts["cp_partial_launches"])
    entries = [
        ("dequant_matmul_u4 tp2", "dequant_matmul.cu",
         "dequant_matmul.py:231", [r for r in dq if r["M"] <= 16],
         pick(dq, M=4, N=28672, K=8192),
         "M=4 N=28672 K=8192 (fused gate/up, tp 2 rank)",
         launches.get(DECODE["uint4"], 0)),
        ("dequant_matmul_u4_tiled tp2", "dequant_wgmma.cuh",
         "dequant_matmul.py:231", [r for r in dq if r["M"] > 16],
         pick(dq, M=256, N=28672, K=8192),
         "M=256 N=28672 K=8192 (fused gate/up, tp 2 rank)",
         launches.get(TILED["uint4"], 0)),
        ("weight_decode_u4 tp2", "weight_decode.cu", "materialize.py:227",
         wd, pick(wd, N=28672, K=8192), "N=28672 K=8192 uint4 -> f16",
         launches.get("weight_decode_u4", 0)),
        ("flash_attention_fwd tp2", "flash_attention.cu", "flash.py:106",
         [fa], fa, "B=1 H=32 Hkv=4 S=512 D=128 causal (a rank's heads)",
         launches.get("flash_attention_fwd", 0)),
        ("flash_decode tp2", "flash_decode.cu", "flash.py:456", [fd], fd,
         "B=4 H=32 Hkv=4 Smax=1024 (a rank's heads)",
         launches.get("flash_decode", 0)),
    ]
    for r in partial:
        entries.append((r["kernel"], "flash_decode.cu" if r["kernel"]
                        == "flash_decode_partial" else "flash_decode_quant.cu",
                        "flash.py:456" if r["kernel"] == "flash_decode_partial"
                        else "flash.py:648", [r], r,
                        "B=4 H=32 Hkv=4 D=128 shard 4096 of Smax=8192, "
                        "partial_stats (launches: tp_options' cp run)",
                        launches.get(r["kernel"], 0)))
    kernels = [{**kernel_entry(name, src, rep, rows, row, shape,
                               {name: n})} for name, src, rep, rows, row,
               shape, n in entries]
    return kernels, laps, summary


# -- slice 18: every Matmul configuration JAX runs (the configs phase) --------

CONFIG_SHAPE = (11008, 4096)        # Llama-2-7B MLP (N, K)
CONFIG_FP8_SHAPE = (14336, 4096)    # Llama-3-8B MLP (N, K): fp8 W8A8 too
CONFIG_MS = (4, 256)
CONFIG_MATERIALIZE_M = 512          # the untuned materialize plan's bound
CONFIG_GROUP = 128
FP64_FLOPS_PER_S = 67e12            # float64 tensor core, data sheet
FP8_FLOPS_PER_S = 1979e12           # dense fp8 tensor core, data sheet
# A class's limit against its plain version: an integer output equal; a
# float one within one ulp of the output type at each value plus
# CONFIG_SUM_FLOOR of sum_k |a_k w_k| at that output (the two sum the same
# products in another order, or in float32 where the plain version takes
# float64: 2^-16 covers float32 sums over K = 4096 with room).
CONFIG_SUM_FLOOR = 2.0 ** -16
CONFIG_LAYERS = (   # (name, Linear keyword arguments, materialize at 512)
    ("float16 -> float32", dict(A_dtype="float16", W_dtype="float16",
                                out_dtype="float32"), False),
    ("bfloat16 -> float32", dict(A_dtype="bfloat16", W_dtype="bfloat16",
                                 out_dtype="float32"), False),
    ("e4m3 x e4m3", dict(A_dtype="e4m3_float8", W_dtype="e4m3_float8",
                         out_dtype="float16"), False),
    ("e5m2 x e5m2", dict(A_dtype="e5m2_float8", W_dtype="e5m2_float8",
                         out_dtype="float16"), False),
    ("e4m3 x e5m2", dict(A_dtype="e4m3_float8", W_dtype="e5m2_float8",
                         out_dtype="float16"), False),
    ("e5m2 x e4m3", dict(A_dtype="e5m2_float8", W_dtype="e4m3_float8",
                         out_dtype="float16"), False),
    ("uint8 x uint8", dict(A_dtype="uint8", W_dtype="uint8",
                           out_dtype="int32"), False),
    ("float64 x float64", dict(A_dtype="float64", W_dtype="float64",
                               out_dtype="float64"), False),
    ("uint16 x float16 g128 bias", dict(
        A_dtype="float16", W_dtype="uint16", with_scaling=True,
        group_size=CONFIG_GROUP, out_dtype="float16", bias=True), True),
    ("int16 x float16", dict(A_dtype="float16", W_dtype="int16",
                             out_dtype="float32"), False),
    ("uint32 x bfloat16 g128", dict(
        A_dtype="bfloat16", W_dtype="uint32", with_scaling=True,
        group_size=CONFIG_GROUP, out_dtype="bfloat16"), False),
    ("int32 x float16 g128", dict(
        A_dtype="float16", W_dtype="int32", with_scaling=True,
        group_size=CONFIG_GROUP, out_dtype="float16"), False),
    ("uint8 x int8", dict(A_dtype="int8", W_dtype="uint8",
                          out_dtype="int32"), False),
    ("nf4 x int8", dict(A_dtype="int8", W_dtype="nf4", out_dtype="int32"),
     False),
    ("fp4_e2m1 x int8", dict(A_dtype="int8", W_dtype="fp4_e2m1",
                             out_dtype="int32"), False),
    ("e4m3 x int8", dict(A_dtype="int8", W_dtype="e4m3_float8",
                         out_dtype="float32"), False),
    ("e5m2 x int8", dict(A_dtype="int8", W_dtype="e5m2_float8",
                         out_dtype="float32"), False),
    ("int8 x int8 g128 bias", dict(
        A_dtype="int8", W_dtype="int8", with_scaling=True,
        group_size=CONFIG_GROUP, out_dtype="float32", bias=True), False),
    ("uint4 x float32 g128 zeros", dict(
        A_dtype="float32", W_dtype="uint4", with_scaling=True,
        with_zeros=True, zeros_mode="original", group_size=CONFIG_GROUP,
        out_dtype="float32"), True),
    ("nf4 x float16 g128 zeros", dict(
        A_dtype="float16", W_dtype="nf4", with_scaling=True,
        with_zeros=True, zeros_mode="original", group_size=CONFIG_GROUP,
        out_dtype="float16"), False),
    ("fp4_e2m1 x bfloat16 g128 zeros rescale", dict(
        A_dtype="bfloat16", W_dtype="fp4_e2m1", with_scaling=True,
        with_zeros=True, zeros_mode="rescale", group_size=CONFIG_GROUP,
        out_dtype="bfloat16"), False),
    ("e4m3 x float16 g128 quantized zeros", dict(
        A_dtype="float16", W_dtype="e4m3_float8", with_scaling=True,
        with_zeros=True, zeros_mode="quantized", group_size=CONFIG_GROUP,
        out_dtype="float16"), False),
)
# JAX's C = 32 QuantConv2D (tests/test_matmul_operator.py:137-228): K =
# 288, off 128, on both routes: uint4 per channel under float16, and under
# int8 activations
CONFIG_CONV = dict(N=2, C=32, H=8, W=8, F=64, K=3, S=1, P=1)


def _config_values(torch, gen, name, shape):
    """Dense values of the dense type `name` on the card: standard normal
    floats, small integers (within 8, unsigned within 16)."""
    from bitblas_tpu_torch.quantization import numerics
    from bitblas_tpu_torch.quantization.formats import INT_TYPES
    if name in INT_TYPES:
        lo, hi = (0, 16) if name.startswith("u") else (-8, 8)
        return numerics.convert(torch.randint(lo, hi, shape, generator=gen,
                                              device="cuda"), name)
    return numerics.convert(torch.randn(shape, generator=gen,
                                        device="cuda"), name)


def _config_layer(torch, gen, kw, N, K):
    """A module.Linear of one class at [K -> N], untuned, with its weight
    (every code; wide values within 2048; e5m2 codes kept finite), scales,
    zeros (quantized: packed along N) and bias loaded on the card."""
    from bitblas_tpu_torch.module import Linear
    from bitblas_tpu_torch.quantization import packing
    from bitblas_tpu_torch.quantization.formats import source_format_and_bits
    kw = dict(kw)
    bias = kw.pop("bias", False)
    lin = Linear(K, N, bias=bias, opt_M=list(CONFIG_MS),
                 enable_tuning=False, device="cuda", **kw)
    cfg = lin.bitblas_matmul.config
    family, bits = source_format_and_bits(cfg.W_dtype)
    G = K // CONFIG_GROUP
    extra = {}
    if cfg.is_native_compute():
        weight = _config_values(torch, gen, cfg.W_dtype, (N, K))
    elif bits > 8:
        lo = -1024 if family == "int" else 0
        weight = torch.randint(lo, lo + 2048, (N, K), generator=gen,
                               device="cuda")
    else:
        weight = torch.randint(0, 1 << bits, (N, K), generator=gen,
                               device="cuda")
        if family == "fp_e5m2":
            weight = torch.where((weight & 0x7C) == 0x7C, weight & 0xBF,
                                 weight)
        if family == "int":
            weight = weight - (1 << (bits - 1)) if bits < 8 else \
                weight.to(torch.uint8).view(torch.int8)
    if cfg.with_scaling:
        extra["scales"] = torch.rand((N, G), generator=gen,
                                     device="cuda") * 0.01 + 0.005
    if cfg.with_zeros:
        z = torch.randint(0, 1 << min(bits, 4), (G, N) if cfg.zeros_mode
                          == "quantized" else (N, G), generator=gen,
                          device="cuda")
        extra["zeros"] = packing.compress(z, min(bits, 8)) if bits < 8 \
            and cfg.zeros_mode == "quantized" else (
                z.to(torch.uint8).view(torch.int8)
                if cfg.zeros_mode == "quantized" else z.float())
    if bias:
        extra["bias"] = torch.randn(N, generator=gen, device="cuda")
    lin.load_and_transform_weight(weight, **extra)
    return lin


def _config_plain(torch, lin, A):
    """The plain version of a Linear's forward on the card: the general
    instance's (`dequant_matmul_general_plain`) for a quantized class, and
    for a native one the float64 product of the same values (exact for the
    integer pairs), cast as the dense route casts."""
    from bitblas_tpu_torch.kernels.dense import add_bias
    from bitblas_tpu_torch.kernels.general import \
        dequant_matmul_general_plain
    from bitblas_tpu_torch.ops.reference import decode_name
    from bitblas_tpu_torch.quantization import numerics
    cfg = lin.bitblas_matmul.config
    if cfg.is_native_compute():
        out = numerics.convert(torch.matmul(
            numerics.to_float(A).double(),
            numerics.to_float(lin.weight).double().T), cfg.out_dtype)
        return out if lin.bias is None else add_bias(out, lin.bias,
                                                     cfg.out_dtype)
    return dequant_matmul_general_plain(
        A, lin.qweight, cfg.W_dtype, cfg.A_dtype, decode_name(cfg),
        lin.scales, lin.zeros, cfg.effective_group_size, cfg.zeros_mode,
        lin.bias, cfg.out_dtype)


def _config_scale(torch, lin, A):
    """sum_k |a_k w_k| of each output: the float64 product of |A| and the
    magnitudes of the decoded weight (a native weight as it is)."""
    from bitblas_tpu_torch.kernels.general import decode_general
    from bitblas_tpu_torch.ops.reference import decode_name
    from bitblas_tpu_torch.quantization import numerics
    cfg = lin.bitblas_matmul.config
    W = lin.weight if cfg.is_native_compute() else decode_general(
        lin.qweight, cfg.W_dtype, cfg.K, decode_name(cfg), lin.scales,
        lin.zeros, cfg.effective_group_size, cfg.zeros_mode)
    return torch.matmul(numerics.to_float(A).double().abs(),
                        numerics.to_float(W).double().abs().T)


CONFIG_MANTISSA = {"float16": 11, "bfloat16": 8, "float32": 24,
                   "float64": 53}
# the native pairs the dense route takes through kernel 9 (float32 sums of
# float16 / bfloat16 operands; fp8 upcast to float16); int8, uint8 and
# float64 stay library products (torch._int_mm, DGEMM)
KERNEL9_ACTS = ("float16", "bfloat16", "e4m3_float8", "e5m2_float8")


def config_err(torch, got, want, out_name, scale) -> float:
    """|got - want| in units of (one ulp of out_name at |want| +
    CONFIG_SUM_FLOOR * scale): at most 1 when within the limit; an integer
    output's largest |got - want| itself (0 when equal). NaN / inf must sit
    where want's are (else inf)."""
    from bitblas_tpu_torch.quantization import numerics
    g = numerics.to_float(got).double()
    w = numerics.to_float(want).double()
    if out_name not in CONFIG_MANTISSA:
        return (g - w).abs().max().item()
    fin = torch.isfinite(w)
    if not (torch.equal(fin, torch.isfinite(g))
            and torch.equal(g[~fin].nan_to_num(), w[~fin].nan_to_num())):
        return math.inf
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1]
                      - CONFIG_MANTISSA[out_name])
    unit = ulp + CONFIG_SUM_FLOOR * scale
    return ((g - w).abs()[fin] / unit[fin]).max().item()


def _config_row(torch, name, lin, A, M, N, K, out, want, scale, flush,
                floor_ms):
    """One timed row of a class at M: the route's time (the Linear's
    forward, one launch of its kernel or library call plus the cast), the
    plain version's, the library call's, the bound and the error."""
    from bitblas_tpu_torch.kernels import dense
    from bitblas_tpu_torch.quantization import numerics
    from bitblas_tpu_torch.quantization.formats import (as_torch_dtype,
                                                        source_format_and_bits)
    cfg = lin.bitblas_matmul.config
    adt = as_torch_dtype(cfg.A_dtype)
    bits = source_format_and_bits(cfg.W_dtype)[1]
    native = cfg.is_native_compute()
    wbytes = N * K * (as_torch_dtype(cfg.W_dtype).itemsize if native
                      else bits / 8)
    if cfg.with_scaling:
        wbytes += (K // CONFIG_GROUP) * N * lin.scales.element_size() * (
            1 + int(cfg.with_zeros))
    nbytes = M * K * adt.itemsize + wbytes + out.numel() * out.element_size()
    peak = (FP8_FLOPS_PER_S if "float8" in cfg.A_dtype
            else INT8_OPS_PER_S if cfg.A_dtype in ("int8", "uint8")
            else FP64_FLOPS_PER_S if cfg.A_dtype == "float64"
            else F32_FLOPS_PER_S if cfg.A_dtype == "float32"
            else F16_FLOPS_PER_S)
    bms, by = bound(nbytes, 2.0 * M * N * K, peak)
    if native and "float8" in cfg.A_dtype and not (
            cfg.A_dtype == cfg.W_dtype == "e5m2_float8"):
        # cuBLASLt's fp8 product (which refuses e5m2 x e5m2)
        library = (lambda: dense.scaled_mm_sums(A, lin.weight))
    elif native and cfg.A_dtype == "uint8":
        a8 = (A.to(torch.int16) - 128).to(torch.int8)
        w8 = (lin.weight.to(torch.int16) - 128).to(torch.int8)
        library = (lambda: dense.int_mm(a8, w8))
    elif native:
        wide = torch.float64 if cfg.A_dtype == "float64" else torch.float32
        Af, Wf = numerics.to_float(A).to(wide), numerics.to_float(
            lin.weight).to(wide)

        def library():
            with dense.full_f32():
                return torch.matmul(Af, Wf.T)
    else:   # the library product of the decoded weight (never called)
        from bitblas_tpu_torch.kernels.general import decode_general
        from bitblas_tpu_torch.ops.reference import decode_name
        Wd = numerics.to_float(decode_general(
            lin.qweight, cfg.W_dtype, K, decode_name(cfg), lin.scales,
            lin.zeros, cfg.effective_group_size, cfg.zeros_mode))
        Af = numerics.to_float(A)

        def library():
            with dense.full_f32():
                return torch.matmul(Af, Wd.T)
    unit, own_ms = None, None
    if not native:
        from bitblas_tpu_torch.kernels.general import general_unit
        from bitblas_tpu_torch.ops.reference import decode_name, sums_type
        dn = decode_name(cfg)
        unit = general_unit(cfg.A_dtype, dn, sums_type(cfg.A_dtype,
                                                        cfg.W_dtype, dn))
        if dn in ("float16", "bfloat16") and cfg.A_dtype == dn:
            # a second yardstick in the 16-bit type itself: torch.matmul
            # on the decoded weight (cuBLAS's f16 / bf16 GEMM)
            W16 = decode_general(lin.qweight, cfg.W_dtype, K, dn,
                                 lin.scales, lin.zeros,
                                 cfg.effective_group_size, cfg.zeros_mode)
            own_ms = time_ms(torch, lambda: torch.matmul(A, W16.T), 10, flush)
    err = config_err(torch, out, want, cfg.out_dtype, scale)
    row = {"class": name, "a_dtype": cfg.A_dtype, "M": M, "N": N, "K": K,
           "unit": unit, "library_own_type_ms": own_ms,
           "route": lin.bitblas_matmul.hint_for(M).decode_mode,
           "kernel_ms": time_ms(torch, lambda: lin(A), 10, flush),
           "plain_ms": time_ms(torch, lambda: _config_plain(torch, lin, A),
                               3, flush),
           "library_ms": time_ms(torch, library, 10, flush),
           "bound_ms": bms, "bound_by": by, "stream_ms": None,
           "floor_ms": floor_ms, "max_abs_err": (
               numerics.to_float(out).double()
               - numerics.to_float(want).double()).abs().nan_to_num()
           .max().item(), "err_units": err}
    return row


def check_configs(torch, flush, floor_ms):
    """The configs phase (slice 18): each class the port added through
    module.Linear at Llama-2-7B's MLP shape (N = 11008, K = 4096; M = 4 and
    256, two classes also at M = 512, the materialize plan), fp8 W8A8 also
    at Llama-3-8B's (14336 x 4096), and JAX's C = 32 QuantConv2D (K = 288)
    on both routes under float16 and int8 activations. First the main
    path alone: the launch counters of kernel 1's and kernels 2-3's general
    instances and of kernel 9 set to 0, every forward run, the counters
    read: each must have launched (kernel 9 for the float16 / bfloat16 ->
    float32 and fp8 classes). Then, outside that count, each output
    against its plain version on the card (`config_err` at most 1: integer
    outputs equal), the conv outputs against the CPU's QuantConv2D (the
    plain versions) at JAX's limits (float16 rtol 2e-2, atol 0.2; int8
    rtol = atol = 1e-3), a second call bit-equal, kernel 2's general
    decode bit-equal to its plain version, and the timed rows (route,
    plain, library: torch.matmul on the decoded weight, torch._scaled_mm
    for e4m3 / cross fp8 pairs, torch._int_mm for uint8; the bound:
    operand and output bytes over 3.35 TB/s, 2 M N K over the operand
    type's peak)."""
    from bitblas_tpu_torch import QuantConv2D, QuantConv2DConfig
    from bitblas_tpu_torch.kernels import dense
    from bitblas_tpu_torch.kernels.general import (
        decode_general, dequant_matmul_general, weight_decode_general)
    F = torch.nn.functional
    from bitblas_tpu_torch.ops.reference import decode_name
    from bitblas_tpu_torch.quantization import numerics
    counters = (dequant_matmul_general, weight_decode_general,
                dense.dense_matmul)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    t0 = time.perf_counter()
    layers = []
    for name, kw, mat in CONFIG_LAYERS:
        N, K = CONFIG_SHAPE
        layers.append((name, _config_layer(torch, gen, kw, N, K), N, K,
                       CONFIG_MS + ((CONFIG_MATERIALIZE_M,) if mat else ())))
    N8, K8 = CONFIG_FP8_SHAPE
    layers.append(("e4m3 x e4m3 (Llama-3-8B)", _config_layer(
        torch, gen, CONFIG_LAYERS[2][1], N8, K8), N8, K8, CONFIG_MS))
    inputs = {}
    for name, lin, N, K, ms in layers:
        for M in ms:
            inputs[(name, M)] = _config_values(
                torch, gen, lin.bitblas_matmul.config.A_dtype, (M, K))
    conv = {}
    for tag, q in (("float16", dict(W_dtype="uint4", group_size=-1,
                                    with_scaling=True)),
                   ("int8", dict(W_dtype="uint4", group_size=-1,
                                 with_scaling=True, in_dtype="int8",
                                 accum_dtype="int32",
                                 out_dtype="float32"))):
        for route in ("fused", "materialize"):
            kw = dict(CONFIG_CONV, **q, route=route)
            conv[(tag, route)] = (QuantConv2D(QuantConv2DConfig(**kw)),
                                  QuantConv2D(QuantConv2DConfig(**kw),
                                              device="cpu"))
    c = CONFIG_CONV
    codes = torch.randint(0, 16, (c["K"], c["K"], c["C"], c["F"]),
                          generator=gen, device="cuda", dtype=torch.uint8)
    cscale = (torch.rand((c["F"], 1), generator=gen, device="cuda") * 0.1
              + 0.01)
    cx = {"float16": torch.randn((c["N"], c["H"], c["W"], c["C"]),
                                 generator=gen, device="cuda").half(),
          "int8": torch.randint(-100, 100, (c["N"], c["H"], c["W"], c["C"]),
                                generator=gen, device="cuda",
                                dtype=torch.int8)}
    packed = {key: ops[0].transform_weight(
        codes, scale=cscale.half() if key[0] == "float16" else cscale)
        for key, ops in conv.items()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # the main path alone, its launches counted
    _reset(counters)
    outs = {}
    for name, lin, N, K, ms in layers:
        for M in ms:
            outs[(name, M)] = lin(inputs[(name, M)])
    conv_out = {key: ops[0](cx[key[0]], *packed[key])
                for key, ops in conv.items()}
    torch.cuda.synchronize()
    launches = {
        "dequant_matmul_general": dequant_matmul_general.launches,
        "weight_decode_general": weight_decode_general.launches,
        **{f"dense_matmul {k}": n
           for k, n in dense.dense_matmul.variant_launches.items()},
        "general_variants": dict(dequant_matmul_general.variant_launches),
        "decode_variants": dict(weight_decode_general.variant_launches)}
    for key in ("dequant_matmul_general", "weight_decode_general",
                "dense_matmul float16->float32",
                "dense_matmul bfloat16->float32"):
        if not launches.get(key):
            raise AssertionError(f"configs: {key} never launched on the "
                                 f"main path ({launches})")
    want_routes = {"fused", "dense", "materialize"}
    for name, lin, N, K, ms in layers:
        for M in ms:
            mode = lin.bitblas_matmul.hint_for(M).decode_mode
            if mode not in want_routes or (mode == "materialize") != (
                    M >= CONFIG_MATERIALIZE_M):
                raise AssertionError(f"configs: {name} at M={M} took the "
                                     f"{mode} route")

    # outside the count: every output against its plain version
    rows, worst = [], {}
    for name, lin, N, K, ms in layers:
        cfg = lin.bitblas_matmul.config
        for M in ms:
            A, out = inputs[(name, M)], outs[(name, M)]
            want = _config_plain(torch, lin, A)
            scale = _config_scale(torch, lin, A)
            err = config_err(torch, out, want, cfg.out_dtype, scale)
            limit = 1.0 if cfg.out_dtype in CONFIG_MANTISSA else 0.0
            if not err <= limit:
                raise AssertionError(f"configs: {name} at M={M} is "
                                     f"{err} units from its plain version")
            again = lin(A)
            if not torch.equal(numerics.to_float(again).nan_to_num(),
                               numerics.to_float(out).nan_to_num()):
                raise AssertionError(f"configs: {name} at M={M}: two calls "
                                     f"differ")
            worst[f"{name} M={M}"] = err
            if M in CONFIG_MS:
                rows.append(_config_row(torch, name, lin, A, M, N, K, out,
                                        want, scale, flush, floor_ms))
                rows[-1]["kernel"] = (
                    "dequant_matmul_general" if not cfg.is_native_compute()
                    else "dense_matmul" if cfg.A_dtype in KERNEL9_ACTS
                    else "library")
        if CONFIG_MATERIALIZE_M in ms:
            # kernel 2's general instance alone: bit-equal, timed
            dn = decode_name(cfg)
            args = (lin.qweight, cfg.W_dtype, K, dn, lin.scales, lin.zeros,
                    cfg.effective_group_size, cfg.zeros_mode)
            got = weight_decode_general(*args)
            want = decode_general(*args)
            same = torch.equal(numerics.to_float(got).nan_to_num(),
                               numerics.to_float(want).nan_to_num())
            if not same:
                raise AssertionError(f"configs: weight_decode_general "
                                     f"{name} differs from its plain version")
            nbytes = lin.qweight.numel() * lin.qweight.element_size() + (
                lin.scales.numel() * lin.scales.element_size() * (
                    1 + int(cfg.with_zeros))) + got.numel() * \
                got.element_size()
            bms, by = bound(nbytes, 0.0)
            rows.append({
                "class": name, "kernel": "weight_decode_general", "M": None,
                "N": N, "K": K, "route": "materialize",
                "kernel_ms": time_ms(torch, lambda: weight_decode_general(
                    *args), 10, flush),
                "plain_ms": time_ms(torch, lambda: decode_general(*args), 3,
                                    flush),
                "library_ms": None, "bound_ms": bms, "bound_by": by,
                "floor_ms": floor_ms, "max_abs_err": 0.0})
    for key, (op, cpu_op) in conv.items():
        tag, route = key
        got = conv_out[key]
        want = cpu_op(cx[tag].cpu(), *[t.cpu() for t in packed[key]])
        rtol, atol = (2e-2, 0.2) if tag == "float16" else (1e-3, 1e-3)
        bad = ((got.cpu().float() - want.float()).abs()
               > atol + rtol * want.float().abs()).sum().item()
        if bad:
            raise AssertionError(f"configs: C = 32 QuantConv2D {tag} "
                                 f"{route}: {bad} outputs off the CPU's")
        ms = time_ms(torch, lambda: op(cx[tag], *packed[key]), 10, flush)
        # the bound of the convolution as the fused route's product: the
        # input, the 4-bit filter and its scales read once, the output
        # written once; 2 M N K over the activations' peak. The library
        # call: cuDNN's float32 convolution (TF32 off) with the decoded
        # filter, codes * scales
        K = c["C"] * c["K"] * c["K"]
        xb = cx[tag].element_size()
        nbytes = (cx[tag].numel() * xb + K * c["F"] / 2
                  + c["F"] * packed[key][1].element_size()
                  + got.numel() * got.element_size())
        bms, by = bound(nbytes, 2.0 * op.m * c["F"] * K,
                        INT8_OPS_PER_S if tag == "int8" else F16_FLOPS_PER_S)
        xf = cx[tag].float().permute(0, 3, 1, 2).contiguous()
        wf = (codes.float() * cscale.float().reshape(1, 1, 1, -1)) \
            .permute(3, 2, 0, 1).contiguous()

        def library():
            with dense.full_f32():
                return F.conv2d(xf, wf, stride=c["S"], padding=c["P"])
        rows.append({"class": f"QuantConv2D C=32 uint4 per channel x {tag}",
                     "kernel": "dequant_matmul_general" if route == "fused"
                     else "weight_decode_general", "route": route,
                     "M": op.m, "N": c["F"], "K": K,
                     "kernel_ms": ms, "plain_ms": None,
                     "library_ms": time_ms(torch, library, 10, flush),
                     "bound_ms": bms, "bound_by": by,
                     "floor_ms": floor_ms, "max_abs_err": (
                         got.cpu().float() - want.float()).abs().max()
                     .item()})
    for r in rows:
        emit({"phase": "configs", **r})
    emit({"phase": "configs_summary", "setup_s": setup_s,
          "seconds": time.perf_counter() - t0, "launches": launches,
          "worst_units": worst})
    return rows, launches


def configs_entries(rows):
    """The kernels line's entries of the configs phase: kernel 1's general
    instance (wide uint16 x float16 g128 at M = 4 as its row; every class's
    rows in max_abs_err), kernels 2-3's general instance, and kernel 9's
    float32 outputs of float16 / bfloat16 (and, upcast, fp8) operands."""
    def of(kernel, **where):
        krows = [r for r in rows if r["kernel"] == kernel]
        return krows, pick(krows, **where)
    out = []
    krows, r = of("dequant_matmul_general",
                  **{"class": "uint16 x float16 g128 bias", "M": 4})
    out.append(("dequant_matmul_general", "dequant_general.cu",
                "dequant_matmul.py:231", krows, r,
                "M=4 N=11008 K=4096 uint16 x f16, g128, bias"))
    krows, r = of("weight_decode_general",
                  **{"class": "uint16 x float16 g128 bias"})
    out.append(("weight_decode_general", "dequant_general.cu",
                "materialize.py:227", krows, r,
                "N=11008 K=4096 uint16 -> f16, g128 (kernel 3's int8 "
                "target too)"))
    for key, cls, acts in (
            ("float16->float32", "float16 -> float32",
             ("float16", "e4m3_float8", "e5m2_float8")),
            ("bfloat16->float32", "bfloat16 -> float32", ("bfloat16",))):
        krows = [x for x in rows if x["kernel"] == "dense_matmul"
                 and x["a_dtype"] in acts]
        r = pick(krows, **{"class": cls, "M": 256})
        out.append((f"dense_matmul {key}", "dense_matmul.cu", "dense.py:73",
                    krows, r, f"M=256 N=11008 K=4096 {cls}"
                    + (" (and the fp8 pairs, upcast)"
                       if key.startswith("float16") else "")))
    return out


# -- slice 19: kernel 4 at every head dim and stride, kernels 5-8 above D =
# 256, H2O-Danube-1.8B (head dim 80) ----------------------------------------

DANUBE_WINDOW = 4096         # h2oai/h2o-danube-1.8b-base's sliding_window
DANUBE_LAYERS = 24
# the reference's depth: one layer, held at the first layer's hidden state
# (ROADMAP "Weak limits after two layers"); its window reduced as
# reference_mistral's (REFERENCE_WINDOW), so the 512-token input crosses it
DANUBE_REF_LAYERS = 1
# The first layer's limit, on what the layer adds to the residual stream
# (hidden state less input, at the prefill's 512 rows and the 4 decode
# steps), relative to its largest value: the hidden state itself is
# mostly the input, which the float32 residual carries exactly, so a limit
# on it lets a faulty layer through. bfloat16 projections round their
# outputs to 2^-8, and the card's sums (split-K, cuBLAS on the decoded
# weight, the d80 kernel's bfloat16 P) flip a few of those roundings.
# Readings (NVIDIA H100 80GB HBM3, 700 W): 1.76e-3 at the prefill, 4.12e-3
# over the decode steps; the limit, 1e-2, is 2.5 bfloat16 roundings.
DANUBE_LAYER1_TOL = 1e-2
# kernel 4's rows of the slice: (name, dtype, S, H, Hkv, D, causal, trans_k,
# window, instance). d80: Danube's longest bucket; the general instance: a
# wide head (512), a head dim outside the wgmma instances (160); the
# aligned route (a wgmma instance behind the layout pass): odd heads at D
# % 8 == 4 (100 x 25 heads), K^T at S % 8 != 0 (2047); the float32 kernel
# at head dims off the 16-bit instances' grid: D % 4 != 0 (6), past 256
# (288), and since the 3xTF32 redesign its cap (768; its D = 128 at H =
# 32 is flashatten's float32 row)
SLICE19_PREFILL = (
    ("d80", "bfloat16", 8192, 32, 8, 80, True, False, DANUBE_WINDOW,
     "wgmma"),
    ("d512", "float16", 2048, 8, 8, 512, True, False, None, "general"),
    ("d160", "bfloat16", 2048, 8, 8, 160, True, False, None, "general"),
    ("d100 x 25 heads", "float16", 2048, 25, 25, 100, True, False, None,
     "aligned"),
    ("ntn S=2047", "float16", 2047, 8, 8, 128, True, True, None, "aligned"),
    ("f32 d6", "float32", 2048, 8, 8, 6, True, False, None, "f32"),
    ("f32 d288", "float32", 2048, 8, 8, 288, True, False, None, "f32"),
    ("f32 d768", "float32", 2048, 8, 8, 768, True, False, None, "f32"),
)
# kernels 5-8 at head dim 512: B = 4, H = 16, Hkv = 4 (group 4), Smax 4096
D512_DECODE = dict(B=4, H=16, Hkv=4, D=512, Smax=4096)
D512_LENGTHS = (1, 37, 2049, 4096)
D512_WINDOW = 1024
D512_DECODE_TOL = 1e-2       # K amplified 20x: tests/test_torch_cuda_kernels
# The D = 512 engine: 2 layers, hidden 2048 = 4 heads x 512, 2 KV heads,
# W4A16 g128 (a shape no public checkpoint JAX's loader takes has: it
# drives kernels 4-8's wide instances through the engines)
D512_ENGINE = dict(hidden_size=2048, intermediate_size=5632, num_heads=4,
                   num_kv_heads=2, num_layers=2, vocab_size=32000,
                   group_size=128)


def danube_1_8b(num_layers: int, window=DANUBE_WINDOW):
    from bitblas_tpu_torch.models.quant_llama import LlamaConfig
    # h2oai/h2o-danube-1.8b-base config.json (arXiv:2401.16818, Table 1):
    # hidden 2560, intermediate 6912, 32 heads of 80, 8 KV heads, vocab
    # 32000, sliding_window 4096, rope_theta 10000, rms_norm_eps 1e-5,
    # torch_dtype bfloat16; uint4 GPTQ g128, original zeros (Mistral's
    # layout), bfloat16 activations
    return LlamaConfig(hidden_size=2560, intermediate_size=6912,
                       num_heads=32, num_kv_heads=8, num_layers=num_layers,
                       vocab_size=32000, group_size=128,
                       act_dtype="bfloat16", rope_theta=10000.0,
                       sliding_window=window, rms_norm_eps=1e-5)


def _variant_count(torch, wrapper, variant: str, fn):
    """Run fn() with the wrapper's counters at 0 and return (fn's result,
    the launches of `variant` it made)."""
    wrapper.launches = 0
    wrapper.variant_launches.clear()
    out = fn()
    torch.cuda.synchronize()
    return out, wrapper.variant_launches.get(variant, 0)


def check_slice19_prefill(torch, flush):
    """Kernel 4's d80 instance at Danube's longest bucket and its general
    instance at the configurations only it takes (SLICE19_PREFILL),
    against the plain version (testing.attention_err: one fa_ulp of |ref|
    plus 4 of the row's rms; K amplified 3x, as check_flashatten). The
    row's launch counter (its variant's) must move; the bound counts the
    band's products (4 B H D sum_i min(i + 1, window)) and the bytes (Q,
    K, V read once, O written once); SDPA on K / V expanded to every head
    (K^T transposed beforehand, the band as a boolean mask) is the
    yardstick."""
    from bitblas_tpu_torch.kernels.flash import (flash_attention_fwd,
                                                 flash_attention_plain,
                                                 prefill_instance,
                                                 prefill_variant)
    from bitblas_tpu_torch.testing import attention_err
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    rows = []
    B = 1
    for tag, dtype, S, H, Hkv, D, causal, trans_k, window, want in \
            SLICE19_PREFILL:
        dt = getattr(torch, dtype)
        instance = prefill_instance(S, H, Hkv, D, dt, trans_k=trans_k)
        if instance != want:
            raise AssertionError(f"slice19 {tag}: routed to the {instance} "
                                 f"instance, not {want}")
        variant = prefill_variant(dt, D, causal=causal, trans_k=trans_k,
                                  window=window, instance=instance)
        Q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
        K = (torch.randn((B, S, Hkv, D), generator=gen, device="cuda")
             * 3).to(dt)
        V = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dt)
        Kin = K.permute(0, 3, 2, 1).contiguous() if trans_k else K
        kw = dict(causal=causal, trans_k=trans_k)
        out, n = _variant_count(torch, flash_attention_fwd, variant, lambda: (
            flash_attention_fwd(Q, Kin, V, window, **kw)))
        if n != 1:
            raise AssertionError(f"slice19 {tag}: {n} launches of "
                                 f"flash_attention_fwd {variant}")
        ref = flash_attention_plain(Q, Kin, V, window, **kw)
        torch.cuda.synchronize()
        u = fa_ulp(torch, dt, dt)
        ratio = attention_err(out, ref, u, 4 * u)
        err = (out.float() - ref.float()).abs().max().item()
        held, extra = ratio <= 1.0, {}
        if dt == torch.float32:
            truth = f32_truth(torch, Q, Kin, V, window, causal, trans_k)
            ratio, to_plain, plain_gap, control, held = f32_held(
                torch, out, ref, truth, u, lambda: flash_attention_plain(
                    Q, Kin, V, window, **kw))
            extra = {"ref": "float64 truth", "err_over_tol_plain": to_plain,
                     "plain_over_tol": plain_gap,
                     "tf32x1_over_tol_plain": control}
            del truth
        if not (held and torch.isfinite(out).all().item()):
            raise AssertionError(f"slice19 {tag}: {ratio} of its limit "
                                 f"(max abs err {err}; {extra})")
        del ref
        qt = Q.transpose(1, 2).contiguous()
        kt, vt = (x.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
                  .contiguous() for x in (K, V))
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal)
        else:
            mask = band_mask(torch, S, window)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask)
        e = Q.element_size()
        nbytes = B * S * D * (2 * H + 2 * Hkv) * e
        keys = band_keys(S, window) if causal else S * S
        peak = F32X3_FLOPS_PER_S if dt == torch.float32 else F16_FLOPS_PER_S
        b_ms, b_by = bound(nbytes, 4.0 * B * H * D * keys, peak)
        row = {"phase": "slice19_prefill", "kernel": "flash_attention_fwd",
               "variant": variant, "tag": tag, "dtype": dtype, "B": B,
               "S": S, "H": H, "Hkv": Hkv, "D": D, "causal": causal,
               "trans_k": trans_k, "window": window, "row_launches": n,
               "max_abs_err": err,
               "max_rel_err": err / out.float().abs().max().item(),
               "err_over_tol": ratio, "ulp": u, "elementwise": PREFILL_TOL,
               "kernel_ms": time_ms(torch, lambda: flash_attention_fwd(
                   Q, Kin, V, window, **kw), 20, flush),
               "plain_ms": time_ms(torch, lambda: flash_attention_plain(
                   Q, Kin, V, window, **kw), 3, flush),
               "library_ms": time_ms(torch, lib, 10, flush),
               "stream_ms": time_ms(torch, _stream(torch, nbytes), 20, flush),
               "bound_ms": b_ms, "bound_by": b_by, "instance": instance,
               **extra}
        if dt == torch.float32:   # the FFMA rate's bound of earlier rows
            row["ffma_bound_ms"] = bound(nbytes, 4.0 * B * H * D * keys,
                                         F32_FLOPS_PER_S)[0]
        emit(row)
        rows.append(row)
        del Q, K, V, Kin, out, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def _d512_caches(torch, gen, quant: bool, paged: bool):
    """Kernels 5-8's operands at D512_DECODE over D512_LENGTHS: the bf16
    cache (K amplified 20x) or its int8 codes and scales, as a slot cache
    of 6 rows (slots 5 / 0 / 3 / 1) or a pool of 16-row blocks through
    permuted tables; rows past each length NaN (int8: extreme codes, NaN
    scales). Returns (caches, index, lengths, dequantized K, V gathered
    [B, Smax, Hkv, D] for the yardstick)."""
    from bitblas_tpu_torch.serving.kv_cache import quantize_kv
    c = D512_DECODE
    B, Hkv, D, Smax = c["B"], c["Hkv"], c["D"], c["Smax"]
    lengths = torch.tensor(D512_LENGTHS, dtype=torch.int32, device="cuda")
    if paged:
        bs, MB = 16, Smax // 16
        blocks = 1 + B * MB
        perm = torch.randperm(blocks - 1, generator=gen, device="cuda") + 1
        index = perm.reshape(B, MB).to(torch.int32)
        shape = (blocks, bs, Hkv, D)
    else:
        index = torch.tensor([5, 0, 3, 1], dtype=torch.int32, device="cuda")
        shape = (6, Smax, Hkv, D)
    kf = torch.randn(shape, generator=gen, device="cuda") * 20
    vf = torch.randn(shape, generator=gen, device="cuda")
    if quant:
        (kc, ks), (vc, vs) = quantize_kv(kf), quantize_kv(vf)
        caches = (kc, vc, ks, vs)
        stale = ((kc, 127), (vc, -128), (ks, float("nan")),
                 (vs, float("nan")))
        kd, vd = kc.float() * ks[..., None], vc.float() * vs[..., None]
    else:
        kc, vc = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        caches = (kc, vc)
        stale = ((kc, float("nan")), (vc, float("nan")))
        kd, vd = kc, vc
    del kf, vf
    if paged:
        gather = (lambda x: x[index.long()].reshape(B, Smax, *x.shape[2:]))
        kg, vg = gather(kd), gather(vd)
        for x, val in stale:
            rows = x[index.long()].reshape(B, Smax, *x.shape[2:])
            for b in range(B):
                rows[b, D512_LENGTHS[b]:] = val
            x[index.long()] = rows.reshape(B, Smax // 16, 16, *x.shape[2:])
    else:
        kg, vg = kd[index.long()], vd[index.long()]
        for x, val in stale:
            for b in range(B):
                x[index[b], D512_LENGTHS[b]:] = val
    return caches, index, lengths, kg, vg


def check_slice19_decode(torch, flush):
    """Kernels 5-8 at head dim 512 (the wide instances: slices of 128
    output columns), float16 queries over bf16 or int8 caches, lengths
    1 / 37 / 2049 / 4096 over Smax 4096; the slot kernels also with a
    window of 1024, and 5-6's partial_stats outputs (m to 1e-3, acc and l
    to 1e-4 of their largest). Each output against its plain version
    within D512_DECODE_TOL (K amplified 20x), the row's launch counter
    moved. The bound counts the live keys' bytes (min(len, window) a
    sequence); the yardstick is SDPA over the gathered caches with the
    length (and window) as a boolean mask."""
    from bitblas_tpu_torch.kernels import flash
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(512)
    c = D512_DECODE
    B, H, Hkv, D, Smax = c["B"], c["H"], c["Hkv"], c["D"], c["Smax"]
    q = torch.randn((B, H, D), generator=gen, device="cuda").half()
    rows = []
    for quant, paged in ((False, False), (True, False), (False, True),
                         (True, True)):
        caches, index, lengths, kg, vg = _d512_caches(torch, gen, quant,
                                                      paged)
        name = ("flash_decode" + ("_paged" if paged else "")
                + ("_quant" if quant else ""))
        kernel = getattr(flash, name)
        plain = getattr(flash, name + "_plain")
        args = ((q, *caches, index, lengths) if paged
                else (q, *caches, lengths, index))
        kgx, vgx = (x.float().nan_to_num().transpose(1, 2).half()
                    .repeat_interleave(H // Hkv, dim=1) for x in (kg, vg))
        per_key = Hkv * (2 * D * (1 if quant else 2) + (8 if quant else 0))
        for window in ((None,) if paged else (None, D512_WINDOW)):
            variant = "float16 d512" + ("" if window is None else " window")
            call = ((lambda: kernel(*args)) if window is None
                    else (lambda w=window: kernel(*args, window=w)))
            out, n = _variant_count(torch, kernel, variant, call)
            ref = plain(*args, *(() if window is None else (window,)))
            err = (out.float() - ref.float()).abs().max().item()
            if not (n == 1 and err <= D512_DECODE_TOL
                    and torch.isfinite(out).all().item()):
                raise AssertionError(f"{name} {variant}: {n} launches, max "
                                     f"abs err {err}")
            pos = torch.arange(Smax, device="cuda")[None]
            live = pos < lengths[:, None].long()
            if window is not None:
                live = live & (pos >= lengths[:, None].long() - window)
            mask = live[:, None, None, :]
            keys = sum(min(n_, window or n_) for n_ in D512_LENGTHS)
            nbytes = keys * per_key + 2 * B * H * D * 2
            b_ms, b_by = bound(nbytes, 4.0 * keys * H * D)
            row = {"phase": "slice19_decode", "kernel": name,
                   "variant": variant, "B": B, "H": H, "Hkv": Hkv, "D": D,
                   "Smax": Smax, "lengths": list(D512_LENGTHS),
                   "window": window, "row_launches": n, "max_abs_err": err,
                   "max_rel_err": err / ref.float().abs().max().item(),
                   "tol": D512_DECODE_TOL,
                   "kernel_ms": time_ms(torch, call, 20, flush),
                   "plain_ms": time_ms(torch, lambda: plain(
                       *args, *(() if window is None else (window,))), 5,
                       flush),
                   "library_ms": time_ms(
                       torch, lambda: F.scaled_dot_product_attention(
                           q[:, :, None], kgx, vgx, attn_mask=mask), 20,
                       flush),
                   "stream_ms": time_ms(torch, _stream(torch, nbytes), 20,
                                        flush),
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            rows.append(row)
        if not paged:   # kernels 5 / 6's partial_stats outputs
            pname = name + "_partial"
            pk = getattr(flash, pname)
            got, n = _variant_count(
                torch, pk, "float16 d512",
                lambda: kernel(*args, partial_stats=True))
            want = flash.flash_decode_partial_plain(
                q, caches[0], caches[1], lengths, index, *caches[2:])
            errs = {}
            for key, a, b, lim in (("m", got[1], want[1], 1e-3),
                                   ("l", got[2], want[2], 1e-4),
                                   ("acc", got[0], want[0], 1e-4)):
                tol = lim if key == "m" else lim * b.abs().max().item()
                errs[key] = (a - b).abs().max().item()
                if not errs[key] <= tol:
                    raise AssertionError(f"{pname} d512 {key}: "
                                         f"{errs[key]} > {tol}")
            if n != 1:
                raise AssertionError(f"{pname} d512: {n} launches")
            keys = sum(D512_LENGTHS)
            full = (torch.arange(Smax, device="cuda")[None]
                    < lengths[:, None].long())[:, None, None, :]
            nbytes = keys * per_key + B * H * (D + 2) * 4 + B * H * D * 2
            b_ms, b_by = bound(nbytes, 4.0 * keys * H * D)
            row = {"phase": "slice19_decode", "kernel": pname,
                   "variant": "float16 d512", "B": B, "H": H, "Hkv": Hkv,
                   "D": D, "Smax": Smax, "lengths": list(D512_LENGTHS),
                   "row_launches": n, "max_abs_err": errs["acc"],
                   "errors": errs,
                   "kernel_ms": time_ms(torch, lambda: kernel(
                       *args, partial_stats=True), 20, flush),
                   "plain_ms": time_ms(
                       torch, lambda: flash.flash_decode_partial_plain(
                           q, caches[0], caches[1], lengths, index,
                           *caches[2:]), 5, flush),
                   "library_ms": time_ms(
                       torch, lambda: F.scaled_dot_product_attention(
                           q[:, :, None], kgx, vgx, attn_mask=full), 20,
                       flush),
                   "stream_ms": time_ms(torch, _stream(torch, nbytes), 20,
                                        flush),
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            rows.append(row)
        del caches, kg, vg, kgx, vgx
        torch.cuda.empty_cache()
    return rows


def check_reference_danube(torch, counters):
    """DANUBE_REF_LAYERS layer at H2O-Danube-1.8B's widths (bfloat16, the
    window reduced to REFERENCE_WINDOW), the card's route -- kernel 1's
    uint4 x bf16 instances, kernel 4's d80 instance over the banded walk
    -- against the plain route on the CPU on the same weights: the
    512-token prefill and 4 teacher-forced decode steps (head dim 80: the
    plain decode attention, JAX's XLA route, on both). Hidden states are
    held within MISTRAL_REF_TOL of the largest, and what the first layer
    adds to them within DANUBE_LAYER1_TOL of its largest."""
    from bitblas_tpu_torch.kernels import flash
    from bitblas_tpu_torch.models.quant_llama import QuantLlama
    t0 = time.perf_counter()
    cfg = danube_1_8b(DANUBE_REF_LAYERS, window=REFERENCE_WINDOW)
    row = {"phase": "reference_danube", "layers": DANUBE_REF_LAYERS,
           "prompt": 512, "decode_steps": 4, "hidden_tol": MISTRAL_REF_TOL,
           "layer1_tol": DANUBE_LAYER1_TOL}
    with CpuWeightMemo():
        gpu, cpu = _card_and_cpu(
            torch, lambda **kw: QuantLlama(cfg, **kw), seed=51)
        _reset(counters)
        x = _reference_input(torch, cfg)
        card, ref = (_run_steps(torch, cfg, model, x, dev)
                     for dev, model in (("cuda", gpu), ("cpu", cpu)))
        d80 = flash.flash_attention_fwd.variant_launches.get(
            "bfloat16 d80 window", 0)
        del gpu, cpu
        torch.cuda.empty_cache()
    xf = x[0].float()
    inputs = (xf, torch.stack([xf[-1], *xf[:4]]))   # each row's input
    bad = []
    for i, key in enumerate(("prefill", "decode")):
        a, b = card[i], ref[i]
        if not torch.isfinite(a).all():
            raise AssertionError(f"reference_danube: non-finite {key} "
                                 f"hidden on the card")
        row[key + "_hidden"] = _gap(a, b)
        row[key + "_layer1_update"] = _gap(a - inputs[i], b - inputs[i])
        bad += [key + "_hidden"] * (row[key + "_hidden"]["max_rel_err"]
                                    > MISTRAL_REF_TOL)
        bad += [key + "_layer1_update"] * (
            row[key + "_layer1_update"]["max_rel_err"] > DANUBE_LAYER1_TOL)
    row.update({"d80_launches": d80, "window": REFERENCE_WINDOW,
                "reduced": {"window": f"{DANUBE_WINDOW} -> "
                                      f"{REFERENCE_WINDOW}: the 512-token "
                                      f"input crosses it",
                            "layers": f"{DANUBE_LAYERS} -> "
                                      f"{DANUBE_REF_LAYERS}"},
                "seconds": time.perf_counter() - t0})
    emit(row)
    if bad:
        raise AssertionError(f"reference_danube: {bad} over their limits")
    if d80 <= 0:
        raise AssertionError("reference_danube: kernel 4's d80 instance "
                             "was not launched")


def check_engine_d512(torch, counters):
    """A 2-layer model at head dim 512 (D512_ENGINE, float16 activations)
    on the token engine (bf16 and int8 caches) and the paged engine (bf16
    and int8 pools), card against the CPU's plain route on the same
    weights (compare_engines / compare_paged: logits within 2e-2 of the
    largest, the serve references' limit). The counters are set to 0
    before and read after: kernel 4's general instance at d512 (the
    prompts' prefill) and kernels 5-8 at d512 must have launched. Returns
    the launches under the kernels line's names."""
    from bitblas_tpu_torch.kernels import flash
    from bitblas_tpu_torch.models.quant_llama import LlamaConfig, QuantLlama
    t0 = time.perf_counter()
    cfg = LlamaConfig(**D512_ENGINE)
    with CpuWeightMemo():
        gpu, cpu = _card_and_cpu(
            torch, lambda **kw: QuantLlama(cfg, **kw), seed=61)
        _reset(counters)
        for quant in (False, True):
            compare_engines(torch, cfg, gpu, cpu, kv_quant=quant,
                            tag="_d512")
            compare_paged(torch, cfg, gpu, cpu, kv_quant=quant,
                          tag="_d512")
        torch.cuda.synchronize()
        launches = {"flash_attention_fwd float16 general d512":
                    flash.flash_attention_fwd.variant_launches.get(
                        "float16 general d512", 0)}
        for name in ("flash_decode", "flash_decode_quant",
                     "flash_decode_paged", "flash_decode_paged_quant"):
            launches[f"{name} float16 d512"] = getattr(
                flash, name).variant_launches.get("float16 d512", 0)
        del gpu, cpu
        torch.cuda.empty_cache()
    if min(launches.values()) <= 0:
        raise AssertionError(f"engine_d512: a kernel was not launched: "
                             f"{launches}")
    emit({"phase": "engine_d512", "config": D512_ENGINE,
          "launches": launches, "seconds": time.perf_counter() - t0})
    return launches


class PlainDecodeCount:
    """The plain decode attention's calls (`kv_cache.flash_decode_plain`,
    the slot cache's route at a head dim D % 128 != 0, JAX's XLA path):
    serve's `reset` and `stats` hooks of a context."""

    def __init__(self):
        from bitblas_tpu_torch.serving import kv_cache
        self.mod, self.orig, self.calls = kv_cache, kv_cache.flash_decode_plain, 0

        def counted(*a, **k):
            self.calls += 1
            return self.orig(*a, **k)

        kv_cache.flash_decode_plain = counted

    def reset(self):
        self.calls = 0

    def stats(self):
        return {"plain_decode_attention_calls": self.calls,
                "plain_decode_attention": "head dim 80: JAX's XLA route "
                                          "(kv_cache.py:795-812)"}

    def close(self):
        self.mod.flash_decode_plain = self.orig


DANUBE_PHASE = ("serve_danube", "token", {},
                MISTRAL_GEMMS + ("flash_attention_fwd bfloat16 d80",
                                 "flash_attention_fwd bfloat16 d80 window"))


def danube_serving_model(torch):
    """24 layers at H2O-Danube-1.8B's widths, W4 g128 original zeros,
    bfloat16 activations, window 4096, random weights drawn on the card
    from a seed, an LMHead of vocab 32000, Mistral's four prompts (1000 /
    3000 / 4500 / 6000: two decode past the window; buckets 4096 and below
    are shorter than the window, 8192 runs the banded walk), max_seq_len
    8192 (a bf16 slot cache of 4 x 8192 rows)."""
    import numpy as np
    from bitblas_tpu_torch.models.hf_import import LMHead
    from bitblas_tpu_torch.models.quant_llama import QuantLlama

    t0 = time.perf_counter()
    cfg = danube_1_8b(DANUBE_LAYERS)
    model = QuantLlama(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    V, Hd = cfg.vocab_size, cfg.hidden_size
    head = LMHead(
        embed=(torch.randn((V, Hd), generator=gen, device="cuda") * 0.05
               ).half(),
        final_norm=torch.ones(Hd, device="cuda"),
        lm_head=torch.randn((V, Hd), generator=gen, device="cuda") * 0.05,
        norm_eps=cfg.rms_norm_eps, device="cuda")
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, n).astype(np.int32)
               for n in MISTRAL_PROMPTS]
    packed = sum(t.numel() * t.element_size()
                 for n, t in model.named_buffers() if "qweight" in n or
                 "scales" in n or "zeros" in n)
    plain = PlainDecodeCount()
    return {"cfg": cfg, "model": model, "head": head, "prompts": prompts,
            "pair": [], "init_s": time.perf_counter() - t0,
            "name": "H2O-Danube-1.8B widths, W4 g128, bf16, window 4096",
            "weight_bytes": packed, "max_seq_len": MISTRAL_MAX_SEQ,
            "reset": plain.reset, "stats": plain.stats, "close": plain.close}


def serve_danube(torch, counters, routes, run=None):
    """serve_danube (24 layers) through `run` (the full run's launch
    accumulator) or serve. The plain D = 80 decode attention's calls are
    the phase's stats; kernel 4 must not refuse a prompt."""
    ctx = danube_serving_model(torch)
    try:
        with routes:
            row = (run(ctx, DANUBE_PHASE, routes) if run is not None
                   else serve(torch, ctx, counters, *DANUBE_PHASE,
                              routes=routes))
    finally:
        ctx["close"]()
    if row["plain_decode_attention_calls"] <= 0 or row["plain_prefills"]:
        raise AssertionError(f"serve_danube: routes {row['launches']}")
    del ctx
    torch.cuda.empty_cache()
    return row


def slice19_entries(prefill, decode):
    """The kernels line's entries of the slice's rows (kernel 4's d80 and
    general instance, kernels 5-8 at d512), named by their launch
    variants."""
    out = []
    for row in prefill:
        src = prefill_source(row["instance"], row["D"])
        out.append((f"flash_attention_fwd {row['variant']}", src,
                    "flash.py:106", [row], row,
                    f"B=1 H={row['H']} Hkv={row['Hkv']} S={row['S']} "
                    f"D={row['D']} {row['dtype']}"
                    + (" K^T" if row["trans_k"] else "")
                    + ("" if row["window"] is None
                       else f" window {row['window']}")))
    reps = {"flash_decode": ("flash_decode.cu", "flash.py:456"),
            "flash_decode_quant": ("flash_decode_quant.cu", "flash.py:648"),
            "flash_decode_paged": ("flash_decode_paged.cu", "flash.py:874"),
            "flash_decode_paged_quant": ("flash_decode_paged_quant.cu",
                                         "flash.py:1020"),
            "flash_decode_partial": ("flash_decode.cu", "flash.py:456"),
            "flash_decode_quant_partial": ("flash_decode_quant.cu",
                                           "flash.py:648")}
    for row in decode:
        src, rep = reps[row["kernel"]]
        out.append((f"{row['kernel']} {row['variant']}", src, rep, [row],
                    row, f"B=4 H=16 Hkv=4 D=512 Smax=4096 lengths "
                    f"1/37/2049/4096" + ("" if row.get("window") is None
                                        else f" window {row['window']}")))
    return out


def danube_phases(torch, counters, flush):
    """`--danube`: the slice alone: kernel 4's d80 and general rows,
    kernels 5-8 at d512, reference_danube, the D = 512 engine and
    serve_danube. Returns its kernels-line entries and launches."""
    prefill = check_slice19_prefill(torch, flush)
    decode = check_slice19_decode(torch, flush)
    check_reference_danube(torch, counters)
    launches = dict(check_engine_d512(torch, counters))
    row = serve_danube(torch, counters, RouteRecorder())
    for name, n in row["launches"].items():
        launches[name] = launches.get(name, 0) + n
    return slice19_entries(prefill, decode), launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    try:
        from bitblas_tpu_torch.kernels import build, flash, materialize
        from bitblas_tpu_torch.kernels import dense as dense_mod
        from bitblas_tpu_torch.kernels.dequant_matmul import (
            dequant_matmul_fmt, dequant_matmul_i2, dequant_matmul_u4)
    except ImportError as e:
        print(f"chip_smoke: run from the root of a bitblas_tpu checkout "
              f"({e})", file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "python": sys.version.split()[0]})
    print(smi, flush=True)

    mode = sys.argv[1:]
    if mode not in ([], ["--bitnet-readings"], ["--bitnet-tuned-ab"],
                    ["--formats"], ["--int-formats"], ["--mistral"],
                    ["--bitnet-3b"], ["--bitnet-3b-readings"],
                    ["--mixtral"], ["--quantize"], ["--ops"],
                    ["--parallel"], ["--configs"], ["--danube"]):
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    logs = build.build()
    ptxas = [ln.strip() for log in logs.values() for ln in log["log"]
             .splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "per_source_s": {k: v["seconds"] for k, v in logs.items()},
          "ptxas": ptxas})
    if mode == ["--bitnet-readings"]:
        bitnet_readings(torch)
        return 0
    if mode == ["--bitnet-3b-readings"]:
        # reference_bitnet_3b's inputs (seed 4, buckets 256 and 512), on
        # its weights (seed 41) and two others
        bitnet_readings(torch, bitnet_b158_3b(2), seeds=(41, 42, 43),
                        inputs=((4, 256), (4, 512)))
        return 0
    counters = all_counters()
    if mode == ["--bitnet-tuned-ab"]:
        bitnet_tuned_ab(torch, counters)
        return 0

    torch.manual_seed(0)
    warm = torch.randn((8192, 8192), device="cuda").half()
    # bring the clocks up, and take the timer's first-call costs, before
    # the first measurement
    time_ms(torch, lambda: warm @ warm, 200)
    del warm
    # the floor of any timed launch: a one-element fill, timed the same way
    one = torch.zeros(1, device="cuda")
    floor_ms = time_ms(torch, one.zero_, 20)
    emit({"phase": "timer_floor", "one_element_fill_ms": floor_ms})
    flush = True
    # wall seconds of each group of phases, since the previous lap (the
    # "seconds" line before the kernels line)
    laps, last = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = now - last[0]
        last[0] = now

    if mode == ["--formats"]:
        check_formats(torch, flush, floor_ms)
        return 0
    if mode == ["--int-formats"]:
        check_int_formats(torch, flush, floor_ms)
        return 0
    if mode == ["--mistral"]:
        mistral_phases(torch, counters, flush)
        return 0
    if mode == ["--mixtral"]:
        k1, k2, row = mixtral_phases(torch, counters, flush)
        entries, counts = mixtral_entries(k1, k2, row["shapes"])
        emit({"kernels": [kernel_entry(*e, counts) for e in entries]})
        return 0
    if mode == ["--quantize"]:
        rows = (check_dequant(torch, flush), check_weight_decode(torch,
                                                                 flush)[0],
                check_flash_attention(torch, flush),
                check_flash_decode(torch, flush))
        tools, laps = model_tools_phases(torch, counters)
        emit({"phase": "seconds", **laps})
        emit({"kernels": [kernel_entry(*e, tools)
                          for e in llama_entries(*rows)]})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if mode == ["--parallel"]:
        tp_kernels, tp_laps, _ = parallel_phases(torch, flush)
        emit({"phase": "seconds", **tp_laps})
        emit({"kernels": tp_kernels})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if mode == ["--configs"]:
        rows, launches = check_configs(torch, flush, floor_ms)
        emit({"kernels": [kernel_entry(*e, launches)
                          for e in configs_entries(rows)]})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if mode == ["--ops"]:
        rows, launches = check_ops(torch, flush)
        emit({"kernels": [kernel_entry(*e, launches)
                          for e in ops_entries(rows)]})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if mode == ["--danube"]:
        entries, launches = danube_phases(torch, counters, flush)
        emit({"kernels": [kernel_entry(*e, launches) for e in entries]})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if mode == ["--bitnet-3b"]:
        fa_rows, fa_launches = check_flashatten(torch, flush)
        row = bitnet_3b_phases(torch, counters)
        fa_counts = flashatten_counts(fa_rows, fa_launches)
        emit({"kernels": [{**kernel_entry(*e, row["launches"]),
                           **fa_counts[e[0]]}
                          for e in flash_summary(fa_rows)]})
        return 0
    dq = check_dequant(torch, flush)
    di2 = check_dequant_i2(torch, flush)
    wd_u4, wd_i8 = check_weight_decode(torch, flush)
    gq, gq_wd = check_gptq_kernels(torch, flush)
    fa = check_flash_attention(torch, flush)
    fd = check_flash_decode(torch, flush)
    fq = check_flash_decode_quant(torch, flush)
    fp = check_flash_decode_paged(torch, flush, quant=False)
    fpq = check_flash_decode_paged(torch, flush, quant=True)
    fa_bw = check_flash_attention_bf16_window(torch, flush)
    fd_w = check_flash_decode_window(torch, flush, quant=False)
    fq_w = check_flash_decode_window(torch, flush, quant=True)
    fp_b = check_flash_decode_paged(torch, flush, quant=False,
                                    qdtype=torch.bfloat16)
    fpq_b = check_flash_decode_paged(torch, flush, quant=True,
                                     qdtype=torch.bfloat16)
    mix_k1, mix_k2 = check_dequant_mixtral(torch, flush)
    s19_prefill = check_slice19_prefill(torch, flush)
    s19_decode = check_slice19_decode(torch, flush)
    lap("kernels")
    # the model tools' phases (their launches join the serve phases')
    tools, tool_laps = model_tools_phases(torch, counters)
    laps.update(tool_laps)
    last[0] = time.perf_counter()
    route_table(torch, flush)
    dense = check_dense(torch, flush)
    check_edges(torch)
    check_window_edges(torch)
    lap("route_dense_edges")
    fa_rows, fa_launches = check_flashatten(torch, flush)
    lap("flashatten")
    fmt_rows, fmt_launches = check_formats(torch, flush, floor_ms)
    lap("formats")
    int_rows, int_launches = check_int_formats(torch, flush, floor_ms)
    lap("int_formats")
    ops_rows, ops_launches = check_ops(torch, flush)
    lap("ops")
    cfg_rows, cfg_launches = check_configs(torch, flush, floor_ms)
    lap("configs")
    # slice 17's phases (the world of two ranks needs the card's memory
    # free of this process's models: none is held here)
    torch.cuda.empty_cache()
    tp_kernels, tp_laps, _ = parallel_phases(torch, flush)
    laps.update(tp_laps)
    last[0] = time.perf_counter()
    # the layers of the GPTQ phases keep their hint database in a
    # temporary directory (never the user's), and their operators leave
    # the global cache when the phases end
    from bitblas_tpu_torch.cache import global_operator_cache
    from bitblas_tpu_torch.common import DATABASE_PATH_ENV
    gptq_db = tempfile.mkdtemp(prefix="bitblas_tpu_torch_db_")
    os.environ[DATABASE_PATH_ENV] = gptq_db
    check_gptq_golden(torch)
    check_linear(torch)
    lap("gptq_golden_linear")
    global_operator_cache.clear()
    check_reference(torch)
    lap("reference")
    check_gptq_reference(torch)
    lap("reference_gptq")
    check_bitnet_reference(torch, counters)
    lap("reference_bitnet")
    ref_mistral = check_reference_mistral(torch, counters)
    lap("reference_mistral")
    check_reference_bitnet_3b(torch, counters)
    lap("reference_bitnet_3b")
    check_reference_mixtral(torch)
    lap("reference_mixtral")
    check_reference_danube(torch, counters)
    lap("reference_danube")
    d512_launches = check_engine_d512(torch, counters)
    lap("engine_d512")

    launches = {c.__name__: 0 for c in counters}
    launches.update({name: 0 for name in (*DECODE.values(),
                                          *TILED.values())})
    # kernels 7 and 8 on bfloat16 queries: the windowless bfloat16 model
    # on the paged engine in reference_mistral (no serve phase runs them)
    for name in ("flash_decode_paged bfloat16",
                 "flash_decode_paged_quant bfloat16"):
        launches[name] = ref_mistral[name]
    # kernel 4's general instance and kernels 5-8 at head dim 512: the D =
    # 512 engine's launches (no served model has such a head dim)
    launches.update(d512_launches)

    def run(ctx, phase, routes=None):
        row = serve(torch, ctx, counters, *phase, routes=routes)
        for name, n in row["launches"].items():
            launches[name] = launches.get(name, 0) + n
        return row

    routes = RouteRecorder()
    ctx = serving_model(torch, "llama")
    for phase in SERVE_PHASES:
        with routes:
            run(ctx, phase, routes)
    del ctx
    torch.cuda.empty_cache()
    ctx = gptq_serving_model(torch)
    with routes:
        run(ctx, GPTQ_PHASE, routes)
    del ctx
    shutil.rmtree(gptq_db)
    torch.cuda.empty_cache()
    lap("serve_llama_gptq")
    ctx = mistral_serving_model(torch)
    for phase in MISTRAL_PHASES:
        with routes:
            run(ctx, phase, routes)
    del ctx
    torch.cuda.empty_cache()
    lap("serve_mistral")
    serve_danube(torch, counters, routes, run)
    lap("serve_danube")
    ctx = bitnet_3b_serving_model(torch)
    with routes:
        run(ctx, BITNET_3B_PHASE, routes)
    del ctx
    torch.cuda.empty_cache()
    lap("serve_bitnet_3b")
    ctx = mixtral_serving_model(torch)
    with routes:
        mix_row = run(ctx, MIXTRAL_PHASE, routes)
    del ctx
    torch.cuda.empty_cache()
    lap("serve_mixtral")
    for name, n in tools.items():
        launches[name] = launches.get(name, 0) + n
    # the bfloat16 model's kernel 1 / 2 launches, under the names of the
    # formats phase's rows for uint4 x bfloat16 (added to its counts)
    for kind in ("decode", "tiled"):
        launches[f"dequant_matmul_fmt {kind} {BF16_U4}"] = launches.get(
            (DECODE if kind == "decode" else TILED)[BF16_U4], 0)
    launches[f"weight_decode_fmt {BF16_U4}"] = launches.get(
        "weight_decode_fmt", 0)
    with routes:
        ctx = serving_model(torch, "bitnet")
        default_row = run(ctx, BITNET_PHASE, routes)
    del ctx
    torch.cuda.empty_cache()
    db_dir = tempfile.mkdtemp(prefix="bitblas_tpu_torch_db_")
    try:
        tune(torch, db_dir)
        with routes:
            # the layers take their operators from the global cache, which
            # now holds the ones loaded from the database
            ctx = serving_model(torch, "bitnet")
            from bitblas_tpu_torch.cache import global_operator_cache
            if not all(p.matmul is global_operator_cache.get(p.config)
                       and not p.matmul.tuned_hints
                       for layer in ctx["model"].layers
                       for p in layer.projs.values()):
                raise AssertionError("serve_bitnet_tuned: a layer's Matmul "
                                     "is not the one loaded from the database")
            tuned_row = run(ctx, BITNET_TUNED_PHASE, routes)
        del ctx
    finally:
        shutil.rmtree(db_dir)
    torch.cuda.empty_cache()
    emit({"phase": "serve_bitnet_tuned_vs_default", **{
        key: {"serve_bitnet": default_row[key],
              "serve_bitnet_tuned": tuned_row[key]}
        for key in ("decode_tok_s", "prefill_tok_s", "decode_step_ms",
                    "routes", "hints")}})
    lap("serve_bitnet_tune")
    emit({"phase": "seconds", **laps})

    lens = "lengths 1/37/513/1024"
    di2_decode = [r for r in di2 if r["M"] <= 16]
    # the Llama path's kernels (kernel 1's uint4 decode and tiled
    # instances, launched by one wrapper and counted apart, kernel 2,
    # kernels 4 and 5), then the rest
    summary = [
        *llama_entries(dq, wd_u4, fa, fd),
        ("dequant_matmul_i2", "dequant_matmul_i2.cu",
         "dequant_matmul.py:231", di2_decode,
         pick(di2, M=4, N=14336, K=4096), "M=4 N=14336 K=4096 int2 x int8"),
        (TILED["int2"], "dequant_wgmma.cuh", "dequant_matmul.py:231",
         [r for r in di2 if r["M"] > 16], pick(di2, M=256, N=14336, K=4096),
         "M=256 N=14336 K=4096 int2 x int8, 64 x 128 tile"),
        ("weight_decode_int8", "weight_decode_int8.cu", "materialize.py:398",
         wd_i8, pick(wd_i8, N=14336, K=4096), "N=14336 K=4096 int2 -> int8"),
        ("flash_decode_quant", "flash_decode_quant.cu", "flash.py:648",
         [fq], fq, f"B=4 H=32 Smax=1024 int8 {lens}"),
        ("flash_decode_paged", "flash_decode_paged.cu", "flash.py:874",
         [fp], fp, f"B=4 H=32 bs=16 MB=64 bf16 {lens}"),
        ("flash_decode_paged_quant", "flash_decode_paged_quant.cu",
         "flash.py:1020", [fpq], fpq, f"B=4 H=32 bs=16 MB=64 int8 {lens}"),
        # kernels 4-8 on bfloat16 queries and with Mistral's window
        ("flash_attention_fwd bfloat16", "flash_attention.cu",
         "flash.py:106", [fa_bw[0]], fa_bw[0],
         "B=1 H=32 Hkv=8 S=512 D=128 bf16 causal"),
        ("flash_attention_fwd bfloat16 window", "flash_attention.cu",
         "flash.py:106", [fa_bw[1]], fa_bw[1],
         "B=1 H=32 Hkv=8 S=8192 D=128 bf16 window 4096"),
        ("flash_attention_fwd float16 window", "flash_attention.cu",
         "flash.py:106", [fa_bw[2]], fa_bw[2],
         "B=1 H=32 Hkv=8 S=8192 D=128 f16 window 4096"),
        ("flash_decode bfloat16 window", "flash_decode.cu", "flash.py:456",
         [fd_w], fd_w, "B=4 H=32 Hkv=8 Smax=8192 bf16 q window 4096 "
         "lengths 1/37/4097/8000"),
        ("flash_decode_quant bfloat16 window", "flash_decode_quant.cu",
         "flash.py:648", [fq_w], fq_w, "B=4 H=32 Hkv=8 Smax=8192 int8 bf16 "
         "q window 4096 lengths 1/37/4097/8000"),
        ("flash_decode_paged bfloat16", "flash_decode_paged.cu",
         "flash.py:874", [fp_b], fp_b, f"B=4 H=32 bs=16 MB=64 bf16 q {lens}"),
        ("flash_decode_paged_quant bfloat16", "flash_decode_paged_quant.cu",
         "flash.py:1020", [fpq_b], fpq_b,
         f"B=4 H=32 bs=16 MB=64 int8 bf16 q {lens}"),
        # no caller in the program (nor in the JAX package): launches 0
        ("dense_matmul", "dense_matmul.cu", "dense.py:73", dense,
         pick(dense, dtype="float16", M=256), "M=256 N=K=4096 f16"),
    ]
    # kernel 1's instances and kernel 2 at GPTQ's group sizes, rescale and
    # bias, launched by the same wrappers and counted by variant
    for variant in dict.fromkeys(r["variant"].split(" ", 1)[1] for r in gq):
        for kind, M, src in (("decode", 4, "dequant_matmul.cu"),
                             ("tiled", 256, "dequant_wgmma.cuh")):
            rows = [r for r in gq if r["variant"] == f"{kind} {variant}"]
            summary.append((
                f"dequant_matmul_u4 {kind} {variant}", src,
                "dequant_matmul.py:231", rows,
                pick(rows, M=M, N=11008, K=4096),
                f"M={M} N=11008 K=4096 uint4 x f16, {variant}"))
    for variant in dict.fromkeys(r["variant"] for r in gq_wd):
        rows = [r for r in gq_wd if r["variant"] == variant]
        summary.append((
            f"weight_decode_u4 {variant}", "weight_decode.cu",
            "materialize.py:227", rows, pick(rows, N=11008, K=4096),
            f"N=11008 K=4096 uint4 -> f16, {variant}"))
    # kernel 1 and kernel 2 for every other format with float activations:
    # each format's decode and tiled instances and its kernel 2, launched
    # by the formats phase (no model serves them: 0 in the serve phases)
    from bitblas_tpu_torch.kernels import dequant_matmul as dq
    from bitblas_tpu_torch.ops.matmul_config import FLOAT_PAIRS, INT_PAIRS
    for a_dtype, w_dtype in FLOAT_PAIRS:
        fmt = f"{w_dtype}x{a_dtype}"
        src = dq.fmt_source(w_dtype, a_dtype) + ".cu"
        k1 = "dequant_matmul.py:231"
        for kind, M, name, rep in (
                ("decode", 4, "dequant_matmul_fmt decode", k1),
                ("tiled", 256, "dequant_matmul_fmt tiled", k1),
                ("weight_decode", None, "weight_decode_fmt",
                 "materialize.py:227")):
            rows = [r for r in fmt_rows if r["format"] == fmt
                    and r.get("kernel") == kind]
            summary.append((
                f"{name} {fmt}",
                "dequant_wgmma.cuh" if kind == "tiled" else src, rep, rows,
                pick(rows, N=11008, K=4096),
                f"{'' if M is None else f'M={M} '}N=11008 K=4096 {w_dtype} "
                f"x {a_dtype}, g128" + (" zeros" if w_dtype.startswith("uint")
                                        else "")))
    for key, n in fmt_launches.items():
        launches[key] = launches.get(key, 0) + n
    # the int_formats phase: kernel 1's integer-column instances (each
    # format's decode and tiled rows, g = 128, int8 out), kernel 3 at 1
    # bit, and uint4 x float16's instances beyond GPTQ's options
    k1, k3 = "dequant_matmul.py:231", "materialize.py:398"
    for a_dtype, w_dtype in INT_PAIRS:
        fmt = f"{w_dtype}x{a_dtype}"
        for kind, M in (("decode", 4), ("tiled", 256)):
            rows = [r for r in int_rows if r["format"] == fmt
                    and r.get("kernel") == kind]
            summary.append((
                f"dequant_matmul_int {kind} {fmt}",
                "dequant_wgmma.cuh" if kind == "tiled"
                else dq.int_source(w_dtype) + ".cu", k1, rows,
                pick(rows, M=M),
                f"M={M} N={rows[0]['N']} K={rows[0]['K']} {w_dtype} x int8, "
                f"g128, {'zeros, ' if w_dtype[0] == 'u' else ''}bias, "
                f"int8 out"))
    rows = [r for r in int_rows if r.get("kernel") == "1bit"]
    summary.append(("weight_decode_int8 1bit", "weight_decode_int8.cu", k3,
                    rows, rows[0], "N=14336 K=4096 int1 -> int8"))
    for kind, name, src, rep in (
            ("decode", "dequant_matmul_fmt decode", "dequant_fmt_uint_f16.cu",
             k1),
            ("tiled", "dequant_matmul_fmt tiled", "dequant_wgmma.cuh", k1),
            ("weight_decode", "weight_decode_fmt", "dequant_fmt_uint_f16.cu",
             "materialize.py:227")):
        rows = [r for r in int_rows if r["format"] == "uint4xfloat16"
                and r.get("kernel") == kind]
        summary.append((f"{name} uint4xfloat16", src, rep, rows, rows[0],
                        "N=11008 K=4096 uint4 x float16, g128, no zeros"
                        + ("" if kind == "weight_decode"
                           else f", M={rows[0]['M']}")))
    for key, n in int_launches.items():
        launches[key] = launches.get(key, 0) + n
    # kernel 1 and kernel 2 at Mixtral-8x7B's expert shapes, with
    # serve_mixtral's launches at those shapes
    entries, counts = mixtral_entries(mix_k1, mix_k2, mix_row["shapes"])
    summary += entries
    launches.update(counts)
    # kernel 4's configurations: launches of the serve phases (head dim
    # 100: serve_bitnet_3b; 0 where no served model runs one), the
    # flashatten phase's apart (flashatten_launches)
    summary += flash_summary(fa_rows)
    fa_counts = flashatten_counts(fa_rows, fa_launches)
    # the ops phase: kernels 1-3 under the operator surface (their
    # launches join the rows of the same names; kernel 3 at uint4 has a
    # row of its own, at the first ResNet-50 shape)
    for key, n in ops_launches.items():
        launches[key] = launches.get(key, 0) + n
    summary += [e for e in ops_entries(ops_rows)
                if e[0] == "weight_decode_int8 uint4"]
    # the configs phase (slice 18): kernel 1's and kernels 2-3's general
    # instances and kernel 9's float32 outputs, with that phase's
    # launches (no serve phase runs them)
    summary += configs_entries(cfg_rows)
    # slice 19: kernel 4's d80 and general instances, kernels 5-8 at d512
    summary += slice19_entries(s19_prefill, s19_decode)
    for key, n in cfg_launches.items():
        if isinstance(n, int):
            launches[key] = launches.get(key, 0) + n
    # kernel 1's wrappers: their decode and tiled instances' launches apart
    split_counts = {
        wrapper: {"decode_launches": launches[DECODE[fmt]],
                  "tiled_launches": launches[TILED[fmt]]}
        for fmt, wrapper in (("uint4", "dequant_matmul_u4"),
                             ("int2", "dequant_matmul_i2"))}
    kernels = [{**kernel_entry(name, src, rep, rows, row, shape, launches),
                **split_counts.get(name, {}), **fa_counts.get(name, {})}
               for name, src, rep, rows, row, shape in summary]
    # slice 17: kernels 1, 2, 4, 5 at serve_tp's rank-local shapes (its
    # launches) and kernels 5 / 6 in partial_stats mode (tp_options' cp run)
    kernels += tp_kernels
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
