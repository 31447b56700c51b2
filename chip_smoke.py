"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

  python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit) and builds every
   hand-written CUDA kernel from ``src/repro_torch/kernels/csrc``;
2. holds each kernel against its plain PyTorch version on the card at the
   shapes of its path — ``qmm`` at every gemma-2b projection at decode M,
   each prompt bucket of the served trace and the training batch, paged
   attention at the serving shape and at slice 8's head layouts (gemma-7b's
   MHA, granite-3-8b's and qwen2.5-14b's GQA, R = 4 and 5), plus check-only
   long rows (every row of each call bit-equal to the same row computed
   alone), ``ds_quant`` (bit-exact) and ``qmv``
   at every shape a path launches them at (gisette's batch 16 × 5000,
   gisette's whole matrix row-scaled at s 15, yearprediction's batch
   16 × 90 at s 7 and 31; ``ds_quant``'s keyed entry, which hashes its
   rounding words in registers, bit-exact with its rand entry; ``qmv`` one
   CUDA launch a call, counted by ``torch.profiler``), the threefry plane
   kernel bit-exact with its int64 path (int32, int64 and f32 planes,
   one key and batched keys, ragged n, counter windows across 2³²) and timed
   at the planes the paths draw against max(bytes / HBM rate, its int32
   operations / the card's int32 rate) — after the paths, every other
   (out, keys, n) they launched it at gets a bit-exact, timed row too, and
   the run fails if a launch of the paths has no row —
   ``row_absmax`` and ``stoch_quant`` (bit-exact, s 3/15/127, f32 and bf16,
   a NaN row for ``row_absmax``) at gisette's whole sample matrix (6000 ×
   5000), the linear path's batch (16 × 5000) and a ragged (13, 1001), and
   ``row_absmax`` also at both path shapes in bf16 and as views 4 bytes
   into their storage, its path rows beside an earlier run's time — and
   times the kernel, the plain version and, where one exists, a PyTorch
   library yardstick beside the card's bound; ``[quantize-rows]`` then runs
   ``ops.quantize_rows`` and ``ops.ds_quantize(scale=None)`` on gisette's
   matrix at s 15 and 32 ``quantize_rows`` draws of the (16, 5000) batch,
   with the ``row_absmax``, ``stoch_quant`` and ``ds_quant`` counters set to
   0 just before and read just after; checks the codes' range, the launch
   counts and that the draws' mean lies within 5 standard errors of x.
   ``qmm`` and ``qmm_qout`` run on the core ``qmm.plan`` chooses (the SIMT
   core at decode M, the tensor cores for bf16 x above
   ``qmm.TC_THRESHOLD`` rows, timed on both sides of it): every row names
   its core and checks it through the wrappers' per-core counters, and
   every path below that launches them fails if a launch ran on another
   core than the one plan gives bf16 x at its shape, or at a shape that no
   row checked;
3. slice 1 — serves full-width gemma-2b (18 layers, d_model 2048, vocab
   256000, random weights from seed 0) through
   ``repro_torch.launch.serve.serve_engine`` at weight/KV bits 8/8 and 4/4 —
   8 requests each — with every kernel's launch counter set to 0 just before
   and read just after each run; checks the served output (every request
   finished with in-vocab tokens; the reduced model on the card agrees with
   the same engine's plain path on the CPU);
4. slice 2 — trains LS-SVM on the paper's gisette proxy at its preset size
   (6000 × 5000) through ``repro_torch.core.linear.train_linear``, e2e 6/8/8
   bits and fp32, lr 0.02 (the reference diverges at 0.3, ROADMAP C6),
   batch 16, 2 epochs (750 steps), with the
   ``ds_quant`` and ``qmv`` counters set to 0 just before the e2e run; checks
   one ``ds_quant`` and four ``qmv`` launches per step and the benchmark's
   convergence criterion (e2e final loss ≤ 1.4 × fp32 + 1e-4); profiles 20
   steps; then trains synthetic100 on the card and on the CPU's plain path
   and checks identical sample codes at every step and equal losses;
5. slice 3 — checks ``qmm_t`` (rel 1e-5, on the tensor-core core that
   ``qmm_t.plan`` gives M 2048; the bound is the same work at the bf16
   rate, the kernel's own floor three times that) and both ``quant_adamw``
   passes (the reference's contract; pass 1's path entry ``qadamw_scales``
   bit-equal to its plain version and to the max of the parity entry's
   partials, NaN kept) at the training path's shapes, then trains
   full-width gemma-2b through ``repro_torch.launch.train.make_trainer`` +
   ``Trainer.run``: batch 4 × 512 tokens, 5 steps, ship-quantized int8
   weights, int8 gradients with error feedback, int8 AdamW moments, with the
   ``qmm``, ``qmm_t``, ``qadamw_scales``, ``qadamw_absmax`` and
   ``qadamw_update`` counters set to 0 just before and read just after (the
   parity entries of both passes must stay at 0, pass 1 launch once a 2-D
   leaf, and the profile must see no device op between pass 1 and pass 2
   of a leaf); checks finite losses, no skipped
   step, a last loss below the first and every ``qmm_t`` launch on the
   tensor cores; profiles 2 more steps (a kernel group that launched but
   reads no device time fails: a renamed kernel); runs the
   bf16 yardstick (no channel, f32 moments, 3 steps), which must launch none
   of the four; trains the reduced model at f32 on the card and on the CPU's
   plain path from one state and checks losses, masters and codes;
6. slice 4 — checks ``qmm_bitplane`` (rel 1e-5) at 9 and 5 planes and the
   serving path's shapes (decode M 4, verify window M 16, every prompt
   bucket of the served trace, M 128), each on the core
   ``qmm_bitplane.plan`` gives it (bf16 x: the tensor cores); ``[rows]``
   holds each of those M's rows bit for bit against the same rows of the
   M 128 product; ``[serve-bitplane]`` and ``[spec]`` fail on a launch at
   an unchecked (P, M, K, N) or off the tensor cores; ``[serve-bitplane]``
   writes full-width gemma-2b's 8-bit bitplane weights
   as a ``weights-bitplane-v1`` artifact under ``build/``, serves the same
   8-request trace at kv 8 from the artifact loaded back (``serve_engine(
   weight_layout="bitplane", ship_dir=...)``), then again at
   ``set_weight_bits(4)``, with the counters set to 0 just before and read
   just after each run (``qmm_bitplane`` > 0, ``qmm`` == 0); ``[spec]``
   serves the trace with ``spec_decode=3, draft_bits=4`` and checks its
   tokens equal the 8-bit run's, then with ``draft_bits=8`` (the draft is
   the served model) and checks every draft token is accepted; ``[check]`` serves the reduced model at
   f32 with 8-bit bitplane weights plain, at ``set_weight_bits(2)`` and with
   speculation, on the card and on the CPU's plain path, and checks equal
   tokens;
7. slice 5 — ``[cheb]``: Fig. 9 as ``benchmarks/bench_chebyshev.py`` runs
   it at full size (cod-rna at its preset 20000 × 8, 6 epochs — the
   benchmark's 12, cut for slice 12's time; logistic
   and SVM in fp32, Chebyshev 'double' at degree 15 × 4-bit samples and
   the 8-bit nearest straw man) with the benchmark's two criteria; the
   SVM's ℓ1 refetch at 8 bits for 8 epochs (refetched fraction < 0.25,
   accuracy > 0.68); logistic 'double' on gisette (6000 × 5000, 2 epochs,
   lr 0.01) for ms per step and falling losses. ``[optimal]``: Fig. 7a as
   ``benchmarks/bench_optimal_quant.py`` runs it on yearprediction (10,000
   × 90, 15 epochs) with its three criteria, the ``ds_quant`` and ``qmv``
   counters set to 0 just before and read just after (the uniform runs take
   one ``ds_quant`` and four ``qmv`` per step). ``[serve-optimal]``: the
   slice-1 trace on full-width gemma-2b with 8-bit variance-optimal level
   weights (kv 8) — ``qmm`` 0 launches, ``paged_decode_attn`` every decode
   step. ``[check]``: 512 cod-rna rows on the card and the CPU's plain path
   (logistic, SVM refetch, optimal levels: identical codes and levels,
   losses within rel 1e-4) and the reduced model served on optimal levels
   (equal tokens);
8. slice 6 — ``[kernel] qmm_qout``: the fused GEMM + double-sampling
   epilogue at gemma-2b's (K, N) × M 2048 / 128 / 4 and a ragged shape
   (int8 and int4 weights, bf16 and f32 x, 8- and 4-bit pairs), bit-exact
   against the unfused ``qmm`` → cast → encode pipeline, within 1e-4 of
   codes of its plain version on the timed draws and, on three seeds'
   draws, of the pair encoded from the f64 product (``QOUT_SEEDS``);
   ``[kernel] qmm_t`` at the tied unembed's
   shapes (M 4 and 1 against the (256000, 2048) table, on the streaming
   core). ``[act-quant]``:
   layer 0 of full-width int8 gemma-2b on one 4 × 512 batch of the training
   stream, ``ds_project`` through its seven projections with the
   ``qmm_qout`` and ``qmm`` counters set to 0 just before and read just
   after (7 and 0), the pairs' range and bit-equality with the unfused
   pipeline, 32 gate draws within 5 standard errors of y, and 5 SGD steps
   of a full-width ``ds_mlp`` block whose loss must fall. ``[serve-embed]``:
   the slice-1 trace on full-width gemma-2b with an 8-bit embedding table
   (``include_embedding=True``), the ``qmm_t``, ``qmm`` and
   ``paged_decode_attn`` counters set to 0 just before and read just after,
   every ``qmm_t`` readout on the streaming core.
   ``[check]``: the reduced model with quantized tables at 8 and 4 bits and
   a reduced ``ds_mlp`` step, card against the CPU's plain path;
9. slice 7 — ``[kernel] ssd_chunk_scan`` (B12): the SSD chunk scan against
   its plain version at mamba2-780m's prefill (B 4, 4 chunks of 256, H 48,
   P 64, N 128, bf16), at the single 1023-row chunk of a 1023-token prompt,
   and there at f32 with an initial state (y rtol = atol = 2e-2 bf16, 1e-4
   f32; the state 1e-4 at both), each on the core ``ssd.plan`` picks from
   x's dtype (bf16 on the tensor cores, bounded at their rate with the
   three-pass floor beside it; f32 on the SIMT kernel), two calls
   bit-equal, and ``qmm`` at mamba2's int8 in_proj (K 1536, N 6448) and
   out_proj (K 3072, N 1536) at decode and prefill M. ``[serve-mamba]``: full-width
   mamba2-780m through ``repro_torch.launch.serve.serve`` (4 prompts of
   1024 tokens, 32 new tokens, random weights from seed 0) at 8-bit weights
   and at bf16, the ``ssd_chunk_scan`` and ``qmm`` counters set to 0 just
   before and read just after (48 SSD launches per prefill, every one on
   the tensor cores); then on the same weights prefill(prompt[:, :-1]) +
   one decode step against prefill(prompt), the bf16 gap reported on the
   tensor cores and, beside it, with the prefills on the SIMT kernel; a
   profile of one prefill (its device ms and SSD's share) and of 5 decode
   steps; every launched shape must have been checked. ``[check]``: the
   reduced model (chunk 16, f32 and bf16, bits 0 and 8) on the card against
   the CPU's plain path;
10. slice 8 — ``[kernel] qmm dense``: ``qmm`` at every projection of
   gemma-7b, granite-3-8b and qwen2.5-14b (int8 and int4, decode M 4 and
   each prompt bucket; qwen2.5-14b's legacy prefill M 128 at int8);
   ``[serve-dense]``: full-width gemma-7b, granite-3-8b and qwen2.5-14b at
   8/8, and qwen2.5-14b at 4/4, through ``serve_engine`` on the slice-1
   trace's prompts (budgets of at most 16 new tokens since slice 12's
   cut) with every gate of slice 1, each run's peak memory and a 2-step
   decode profile; ``[serve-legacy-dense]``: full-width qwen2.5-14b through the
   legacy ``serve`` (ring KV cache, int8 weights and KV, 4 prompts of 32, 16
   new tokens; ``qmm`` 7 × L a prefill and a step, ``paged_decode_attn``
   0), its prefill logits bit-equal to the paged engine's prefill on the
   same prompts; ``[check dense]``: the three reduced models at f32 (qwen's
   q/k/v biases nonzero), 8 and 4 bits, engine and legacy loop on the card
   against the CPU's plain path;
11. slice 9 — ``[kernel] ssd zamba2``: B12 at zamba2-2.7b's prefill (B 4,
   4 chunks of 256, H 80, P 64, N 64: half of phase 1's state block) on the
   tensor cores, the single 1023-row chunk, and f32 on the SIMT kernel with
   and without an initial state, under slice 7's tolerances; ``[kernel]
   qmm zamba2``: B5 at its in_proj (N 10448), out_proj, q/k/v/o, gate/up
   and down, int8 and int4, at decode M 4 and the prefills' M 4096 and
   4092. ``[serve-hybrid]``: full-width zamba2-2.7b (54 Mamba2 layers and
   one shared attention block after every 9, random weights from seed 0)
   through the legacy ``serve`` (4 prompts of 1024, 16 new tokens since
   slice 12's cut, a 2-step decode profile) at
   weight/KV bits 8/8, 4/4 and bf16, with ``[serve-mamba]``'s gates: 54
   SSD launches a prefill on the tensor cores, ``qmm`` 2 × 54 + 7 × 6 =
   150 a prefill and a decode step at int bits (0 at bf16), peak memory,
   the Mamba2 and shared KV cache bytes, prefill and decode profiles, and
   the f32 prefill/decode consistency gated from the reference's own gap
   (``HYBRID_CONSISTENCY_TOL``); ``[check hybrid]``: the reduced model at
   f32 and bf16, weight/KV bits 0/8/4, on the card against the CPU's plain
   path, both fed the CPU's greedy tokens (f32 logits within 1e-4 where
   the KV rows are raw; tokens equal but at near-ties);
12. slice 10 — ``[kernel] qmm moe``: B5 at every (K, N) of
   granite-moe-3b-a800m — q/o, k/v and an expert's gate/up, the router's
   N 40 (int8 rows of 40 bytes, packed int4 rows of 20), an expert's down —
   int8 and int4, at decode M 4, each prompt bucket and the profile's 64,
   the dispatch's capacity 1024 and the legacy prefill's 4096; ``[kernel]
   paged_decode_attn moe``: B10 at its (24, 8, 64) layout (D 64, R 3);
   ``[serve-moe]``: full-width granite-moe-3b-a800m (40 experts, top 8,
   random weights from seed 0) through ``serve_engine`` at 8/8 and 4/4 on
   the slice-1 trace's prompts (budgets of at most 16 new tokens since
   slice 12's cut) with every gate of slice 1 — ``qmm`` 32 × (4 + 1 + 3 × 40) = 4000 launches a
   decode step and a prefill, one a projection, the router and each expert
   slice, at checked shapes; ``paged_decode_attn`` 32 a step — peak memory,
   weight bytes, a 1-step decode profile, and at 8/8 the cuda backend
   against the ref backend on the card, teacher-forced for 4 steps (8
   before slice 12's cut; tokens equal but
   at near-ties or after a routing difference; on the same input every
   routing difference at a near tie);
   ``[serve-legacy-moe]``: the legacy ``serve`` at 8/8 (4 prompts of 1024:
   the prefill's experts run at the dispatch's capacity M 1024; 32 new
   tokens), a profiled prefill (device ms, ``qmm``'s share, each layer's
   dropped-choice share at capacity) and 1 profiled decode step;
   ``[check moe]``: the reduced model at f32, weight/KV bits 0/0, 8/8 and
   4/4, engine and legacy loop (2 × 384 prompts: the dispatch) on the card
   against the CPU's plain path, the routing captured on both sides (every
   difference at a near tie);
13. slice 11 — ``[kernel] qmm mixtral``: B5 at every (K, N) of
   mixtral-8x7b — q/o, k/v, the router's N 8 (int8 rows of 8 bytes, packed
   int4 rows of 4), an expert's gate/up and down — int8 and int4, at decode
   M 2, the prefill's M 16384 (q, k, v, o, the router) and the dispatch's
   capacity 5120 (the experts); ``[serve-mixtral]``: full-width
   mixtral-8x7b (8 experts, top 2, sliding window 4096; 46.6 B parameters,
   random weights from seed 0, each weight encoded a layer at a time as it
   is drawn) through the legacy ``serve`` at 8/8 and 4/4 (2 prompts of
   8192 = 2 W, the length at which the reference's ring holds the window,
   ROADMAP C24; 32 new tokens): ``qmm`` 32 × (4 + 1 + 3 × 8) = 928 a
   prefill and a decode step, the prefill's experts at the dispatch's
   capacity M 5120, peak memory under the card's 80 GB, the codes' bytes,
   the build's seconds on a line of their own, a profiled prefill (device
   ms, ``qmm``'s share, each layer's dropped-choice share), the ring (4096
   rows a layer; the first decode step writes slot 0, position 4096's, and
   no other) and a profiled decode step (device ms, idle share, wall);
   ``[check window]``: layers 0 and 31's attention blocks of the int8
   build at f32 on 8193 random rows — ring prefill of 8192 plus
   ``attention_decode_step`` at position 8192 within 1e-4 of the windowed
   block's last row, and at least 100 times that from the unwindowed
   block's (the window binds); at int8 KV reported; ``[check mixtral]``:
   the reduced model (window 32) at f32, weight/KV bits 0/0 and 8/8, the
   legacy loop on prompts of 64 (the ring's identity order) and 40 (C24)
   on the card against the CPU's plain path (tokens equal but at near
   ties or after a routing difference; raw-KV logits within 1e-5);
13b. slice 12 — ``[kernel] qmm vlm``: B5 at every (K, N) of
   llama-3.2-vision-11b — q/o, k/v, gate/up, down — int8 and int4, at
   decode M 4 and the prefill's M 4096, and the cross blocks' k/v of the
   4 × 4096 vision tokens at M 16384; ``[kernel] qmm audio``: B5 at
   musicgen-medium's (1536, 1536), (1536, 6144) and (6144, 1536) at
   decode M 4 and each prompt bucket of the trace; ``[kernel]
   paged_decode_attn audio``: B10 at its (24, 24, 64) MHA layout (D 64,
   R 1). ``[serve-vlm]``: full-width llama-3.2-vision-11b (a cross block
   over 4096 vision tokens after every 5 of its 40 layers; random weights
   from seed 0, each weight encoded a layer at a time as it is drawn, the
   build timed) at 8/8 and 4/4 through ``make_prefill_step(cfg,
   pad_to=1056)`` and ``make_serve_step`` (4 prompts of 1024 from the
   reference's draw, 4096 f32 normal vision stand-ins a prompt from a
   numpy seed, 32 new tokens): ``qmm`` 40 × 7 + 8 × 4 = 312 a prefill and
   40 × 7 + 8 × 2 = 296 a decode step at checked shapes on plan's core,
   ``paged_decode_attn`` 0; the ring 1056 rows a layer; the cross caches
   8 × 2 planes of (4, 4096, 8, 128) raw bf16, 536,870,912 bytes, at both
   widths; the codes' bytes; peak memory under 80 GB; a profiled prefill
   (device ms, ``qmm``'s and the cross blocks' shares) and decode step
   (device ms, idle share, wall). ``[check cross]``: cross blocks 0 and 7
   of the int8 build at f32 on the stand-ins — the prefill's contribution
   at the last position within 1e-4 of ``_cross_decode``'s on the cached
   K/V, nonzero, and exactly 0 on zero vision tokens (the reference's
   legacy loop feeds zeros, ROADMAP C25); ``[check vlm]``: the reduced
   model at f32, 0/0 and 8/8, card against the CPU's plain path (tokens
   equal, raw-KV logits within 1e-5). ``[serve-audio]``: full-width
   musicgen-medium through ``serve_engine`` on the slice-1 trace at 8/8
   and 4/4 with every gate of ``[serve]`` (``qmm`` 7 × 48 a decode step,
   ``paged_decode_attn`` 48) and a 2-step decode profile; ``[check
   audio]``: the reduced model through the engine at 0/0 (bf16: B10 takes
   raw pages in bf16 alone; first tokens equal), 8/8 and 4/4 (f32: every
   token equal), card against the CPU's plain path. To pay for these phases slice 12 cut
   depth from four earlier ones, each still launching every kernel at
   every shape it did and keeping its gates: ``[serve-dense]`` and
   ``[serve-moe]`` serve the trace with budgets of at most 16 new tokens
   (the same prompts), ``[serve-dense]`` profiles 2 decode steps and
   ``[serve-moe]``'s teacher-forced check runs 4; ``[cheb]`` runs Fig. 9
   for 6 epochs; ``[serve-hybrid]`` decodes 16 new tokens and profiles 2
   steps;
13c. slice 13 — ``[kernel] qmm features``: B5 at gemma-2b's four (K, N),
   int8, at every M ``[serve-features]`` launches it at that no earlier
   row checked: a prefill chunk's M 32 (``chunk_pages`` 2 × page 16) and
   the shared-prefix trace's prompt buckets; ``[kernel] paged_decode_attn
   features``: B10 at a chunk's call (32 queries of one sequence at
   gemma-2b's (8, 1, 256), int8, ``seq_len = min(position + 1, prompt
   length)``). ``[serve-features]``: full-width gemma-2b at 8/8 (one
   weight tree shared by every engine), every request sampled at
   temperature 0.8, top-k 40, in five runs, each with the ``qmm``,
   ``paged_decode_attn`` and threefry counters set to 0 just before and
   > 0 just after, every ``qmm`` launch at a checked shape on plan's core
   and 7 × 18 ``qmm`` and 18 B10 launches a decode step and a prefill
   chunk: (1) the slice-1 trace monolithic, two of its requests re-served
   alone with the same tokens, and a profiled decode; (2) a shared-prefix
   trace (8 requests, 2 families of a 64-token prefix + 8–40 private
   tokens, 8–16 new) with ``prefix_cache=True, chunk_pages=2`` — ≥ 6
   prefix hits, the tokens of the same trace chunked without a cache,
   leak-free after ``release_prefix_cache`` — and a profiled chunked
   decode; (3) that trace monolithic under ``reserve='none'`` with a pool
   that holds the first four prompts and nothing more: ≥ 1 preemption,
   the tokens of ``reserve='full'``; (4) on a ``VirtualClock``:
   ``nan_logits`` fails one request alone with reason 'nan', and a
   ``kv_flip`` in a shared trie page between two waves gets it evicted
   (the second wave's tokens are the cache-free run's); (5)
   ``ReplicaSet(2)`` on the one card, ``dispatch='prefix'``, replica 0
   raising at set steps 4 and 5: every request finishes once with the
   fault-free tokens, replica 0 restarts, every pool drains leak-free.
   ``[check serve-features]``: the reduced model at f32, 8/8, card against
   the CPU's plain path: chunked, prefix and preempting runs (greedy)
   every token equal with the same hits and preemptions; a sampled run
   whose tokens may part only where the CPU's two largest perturbed
   scores lie within 1e-3;
14. every plane the paths draw on the card takes the threefry kernel: a
   phase fails if ``prng`` made an int64 hash on the card in it (its
   counter, set to 0 just before each phase but the kernels'), and the main
   paths' plane launches are counted by (output, keys, size) for the
   ``kernels`` line; ``quant_adamw`` pass 2 and ``ds_quant`` run their keyed
   entries on the paths (their rand entries 0 launches);
15. prints each phase's wall seconds (``[phase]``), a ``{"kernels": [...]}``
   line and, last, the result line ``{"ok": true, "device": {...}}``.

Any failure raises (exit code ≠ 0) and prints no result line; so does a
machine without a card, or a directory without the repository's sources.
"""
from __future__ import annotations

import collections
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA data sheet
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12             # H100 SXM f32 outside the tensor cores
# 32-bit integer add, logic and shift results per clock per SM: the CUDA C++
# Programming Guide's arithmetic-instruction throughput table, compute
# capability 9.0; times the SMs and the card's maximum SM clock as nvidia-smi
# reports it (clocks.max.sm), the int32 rate that bounds the threefry hash.
# Of a word's 73 operations the 41 funnel shifts and xors run only on the
# integer ALU pipe at that rate; ptxas issues most adds as IMAD on the FMA
# pipe, which adds as many a clock (the table's 32-bit integer multiply-add
# row), so the hash's bound is max(41 at the rate, 73 at twice it)
INT32_PER_CLK_SM = 64
INT32_OPS = None              # ops/s, set in main() from the card's clock
HASH_OPS = 73                 # 32-bit integer operations of one threefry word (threefry.cuh)
HASH_ALU_OPS = 41             # ... of which funnel shifts and xors: the ALU pipe alone
# threefry plane kernel rows: (out, key batch, plane shape). Bit-exact at
# TF_CHECKS; timed at these planes the paths draw (the paths' other planes
# get rows of their own after the paths run): B4's (16, 5000) in
# [quantize-rows] (and B1's former (16, 90) plane, now hashed in its
# registers), the e2e linear step's model and gradient (5000,), [optimal]'s
# batched level planes (625 steps × 180 keys of the batch's 16 rows, one
# launch an epoch) and the gate/up leaf's uniform (the model and gradient
# channels of [train])
TF_ROWS = [("int32", 1, (16, 90)), ("int32", 1, (16, 5000)), ("f32", 1, (5000,)),
           ("f32", 625 * 180, (16,)), ("f32", 1, (36864, 16384))]
# (out, keys, shape, start): one key and batched keys at ragged n, and
# windows of counters across 2³² (one key and 3 keys)
TF_CHECKS = [(out, k, shape, start) for out in ("int32", "int64", "f32")
             for k, shape, start in ((1, (1001,), 0), (1, (16, 90), 0), (180, (16,), 0),
                                     (3, (333, 7), 0), (1, (100000,), 2 ** 32 - 50000),
                                     (3, (4099,), 5 * 2 ** 32 - 2000))]
QMM_SHAPES = [(4, 2048, 2048), (4, 2048, 256), (4, 2048, 16384),
              (4, 16384, 2048), (128, 2048, 16384),
              # the training path: M = B·S = 2048 tokens (slice 3)
              (2048, 2048, 2048), (2048, 2048, 256), (2048, 2048, 16384),
              (2048, 16384, 2048)]
QMM_TOL = 1e-5                # rel to max|plain|: f32 dequant, f32 accumulation order
ATTN_TOL = 1e-4               # abs: both f32 online softmax, summation order only
ATTN_LENS = [160, 97, 33, 1]
# B10 at slice 8's head layouts (gemma-7b's MHA, granite-3-8b's GQA,
# qwen2.5-14b's GQA with R = 5 query heads a kv head) at ATTN_LENS, each
# on [serve-dense]'s path, and check-only long rows at gemma-2b's layout
ATTN_DENSE_LAYOUTS = {(16, 16, 256): "gemma-7b", (32, 8, 128): "granite-3-8b",
                      (40, 8, 128): "qwen2.5-14b"}
ATTN_LONG_LENS = [4096, 1500, 257, 0]
# B10 at granite-moe-3b-a800m's layout (D 64, R 3), on [serve-moe]'s path
ATTN_MOE_LAYOUT = (24, 8, 64)
# ds_quant cases: (R, C, scale axis, s); each is bit-exact at DS_S and its
# own s, and timed at its own s. On the paths: slice 2's gisette batch
# (6-bit samples, s 63), [quantize-rows]' ds_quantize(scale=None) of
# gisette's matrix (s 15) and [optimal]'s yearprediction batch (uniform 3
# and 5 bits, s 7 and 31)
DS_CASES = [(16, 5000, "col", 63), (6000, 5000, "row", 15), (16, 90, "col", 7),
            (1024, 2048, "col", 63), (1024, 2048, "row", 63), (13, 1001, "col", 63)]
DS_S = (3, 31, 63, 127)
# qmv cases: (R, C of the stored plane, transposed view); on the paths: the
# (16, 5000) plane of slice 2's gisette batch and the (16, 90) plane of
# [optimal]'s yearprediction batch, each with its transpose
QMV_CASES = [(16, 5000, False), (16, 5000, True), (16, 90, False), (16, 90, True),
             (1024, 2048, False), (1024, 2048, True), (13, 1001, False), (13, 1001, True)]
QMV_TOL = 1e-5                # rel to max|plain|: f32 accumulation order
# lr 0.02, not the 0.3 of the small benchmarks: on gisette's 5000 features a
# batch of 16 has curvature ~43, so SGD is stable only below lr ~0.05; at
# 0.3 the reference itself diverges (fp32 and e2e losses NaN after epoch 1,
# ROADMAP C6). Of 0.1/0.05/0.03/0.02/0.01/0.003, lr 0.02 reaches the lowest
# fp32 loss in 2 epochs on the reference.
LINEAR = dict(model="lssvm", epochs=2, batch=16, lr=0.02)
LINEAR_LOSS_TOL = 1e-5        # rel: card vs CPU plain path, same codes, sums reordered
# qmm_t at the training path's shapes: M = B·S = 2048 tokens, (K, N) of the
# seven stacked weights of a gemma-2b layer (q/o, k/v, up/gate, down)
QMM_T_SHAPES = [(2048, 2048, 2048), (2048, 2048, 256), (2048, 2048, 16384),
                (2048, 16384, 2048)]
# quant_adamw at every leaf shape of full-width gemma-2b flattened to (rows,
# last dim): up/gate, embed.table, k/v, ln1/ln2, q/o, down
ADAMW_SHAPES = [(36864, 16384), (256000, 2048), (36864, 256), (18, 2048),
                (36864, 2048), (294912, 2048)]
ADAMW_NAN_SHAPE = (36864, 256)  # ... where a NaN in g is checked (k/v)
ADAMW_KW = dict(qmax=127, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, lr=1e-4, b1c=0.1,
                b2c=0.05, clip=0.5, finite=1.0, uclip=10.0)
# pass 1's ms at each leaf before its redesign (the parity entry, whose
# partials the host reduced in ten more ops): chip_smoke.py on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md's kernel table before the path entry);
# printed beside the path entry's rows, used in no check
ADAMW_PASS1_BEFORE_MS = {(36864, 16384): 1.5004, (256000, 2048): 1.3264, (36864, 256): 0.1524,
                         (18, 2048): 0.0147, (36864, 2048): 0.2999, (294912, 2048): 1.5069}
# the training path: full-width gemma-2b, all three ZipML channels at 8 bits.
# lr 1e-5 (warmup 1 step, cosine over 5): Adam's first steps move every weight
# by ~lr whatever its gradient, and at this width 1e-4 and 3e-5 overshoot
# (the loss rose again within the 5 steps); 1e-5 falls at every step.
TRAIN = dict(batch=4, seq=512, steps=5, lr=1e-5)
TRAIN_CHECK_TOL = 1e-4        # rel: card vs CPU plain path, f32, sums reordered
# the [check] run's optimizer: lr 1e-3 from the first step, so that three
# steps move a master by ~3e-3, 10⁴ × the f32 ulp of the largest masters and
# far above TRAIN_CHECK_TOL (the default warmup of 100 steps moves one by
# < 2e-5: a check of the masters themselves could not see the update)
TRAIN_CHECK_OPT = dict(lr=1e-3, warmup_steps=1)
# a free run's masters' update, relative L2 distance card vs CPU: a flipped
# stochastic code re-draws its moment column on the next step, so free runs
# part by far more than TRAIN_CHECK_TOL; a frozen master or a wrong lr gives
# 0.1 to 1
FREE_RUN_UPDATE_L2 = 5e-2
# qmm_bitplane: the served 8-bit artifact (9 planes) and its 4-bit draft
# view (5 planes), at decode (M 4 = the slots), the verify window (M 16 = 4
# slots × (3 drafts + 1)) and prefill (M = every prompt bucket of the
# served trace, and 128, the largest there can be), for gemma-2b's (K, N):
# q/o, k/v, gate/up, down; plus one ragged shape. Every row runs on the
# core qmm_bitplane.plan gives its x (bf16: the tensor cores); the rows of
# every M are held bit for bit against the M 128 product's
QBP_PLANES = (9, 5)
QBP_KN = ((2048, 2048), (2048, 256), (2048, 16384), (16384, 2048))
QBP_RAGGED = (13, 1001, 1000)
SERVE = dict(n_requests=8, max_slots=4, page_size=16, max_prompt=128, max_new=32)
SPEC = dict(spec_decode=3, draft_bits=4)
# the control: a draft at the serving bits is the served model itself, so
# every drafted token must be accepted (the verify window computes what
# sequential decode computes) — acceptance exactly 1
SPEC_CONTROL = dict(spec_decode=3, draft_bits=8)
# row_absmax / stoch_quant: gisette's whole sample matrix, the linear path's
# batch and a ragged shape, f32 (and bf16 at the first), s checked bit-exact
SQ_CASES = [(6000, 5000), (16, 5000), (13, 1001)]
SQ_S = (3, 15, 127)
SQ_PATH_S = 15                # [quantize-rows]: 4-bit codes, s = 2^4 − 1
SQ_DRAWS = 32                 # unbiasedness: mean of 32 draws at (16, 5000)
# row_absmax's ms on [quantize-rows]' shapes in an earlier run of the same
# kernel (PERF.md's table); printed beside its rows, used in no check
ROW_ABSMAX_BEFORE_MS = {(6000, 5000): 0.0542, (16, 5000): 0.0077}
SQ_SE = 5.0                   # ... within 5 standard errors of x
# Fig. 9 as benchmarks/bench_chebyshev.py runs it at full size: cod-rna
# (make_dataset's preset: 20000 × 8 training rows whatever n_train asks,
# ROADMAP C12), 6 epochs (the benchmark's 12 halved for the script's time:
# on the port's CPU path both criteria hold at 4, 6 and 12 epochs, the
# SVM's at 6 by 0.030, at 12 by 0.035); logistic lr 0.4, SVM lr 0.2 with the ball prox;
# fp32, cheb_8bit ('double': degree 15 × 4-bit samples) and nearest_8bit.
# Its criteria: Chebyshev test accuracy within 0.05 (logistic) / 0.12 (SVM)
# of fp32's, and the straw man at least as good less 0.02 (§5.4).
CHEB = dict(epochs=6, batch=16)
CHEB_RUNS = {"fp32": ("full", 8), "cheb_8bit": ("double", 4), "nearest_8bit": ("nearest", 8)}
CHEB_MODELS = {"logistic": (0.4, "none", 0.05), "svm": (0.2, "ball", 0.12)}
# App. G.4 as tests/test_linear_models.py runs it: cod-rna seed 1, SVM,
# 'double' at 8 bits, ℓ1 refetch, 8 epochs, lr 0.2, ball prox
REFETCH = dict(model="svm", epochs=8, lr=0.2, reg="ball", refetch="l1")
# logistic 'double' at gisette's full width for ms per step. lr 0.01: of
# 0.4/0.1/0.05/0.02/0.01/0.005/0.003 it reaches the lowest Chebyshev loss
# in 2 epochs on the reference (ROADMAP C15 gives the sweep's command and
# losses; at 0.4 the first epoch ends above ln 2). The §4.2 ball (radius
# R/max‖a‖ ≈ 0.6 here) binds, so the Chebyshev loss stays above fp32's at
# every lr
GISETTE_LOGISTIC = dict(model="logistic", epochs=2, batch=16, lr=0.01)
# Fig. 7a as benchmarks/bench_optimal_quant.py runs it: yearprediction
# 10,000 × 90, 15 epochs, lr 0.3, uniform and optimal levels at 3 and 5 bits
OPTIMAL = dict(epochs=15, lr=0.3)
# [check]: the card against the CPU's plain path on 512 cod-rna rows
CHECK_ROWS = 512
CHECK_LOSS_TOL = 1e-4         # rel: the CPU parity tests' tolerance (free runs: 1.5e-7)
# qmm_qout (B7): gemma-2b's (K, N) of q/o, k/v, gate/up and down at the
# training batch (M 2048 = 4 × 512: [act-quant]'s path), prefill (M 128) and
# decode (M 4), plus a ragged shape; int8 and packed-int4 weights, bf16 and
# f32 x, 8- and 4-bit pairs. Bit-exact against the unfused qmm → cast →
# encode pipeline; against the plain version (f32 sums in another order)
# codes may differ only where the two y differ after the cast (or the row
# scales differ), on at most QOUT_SHARE of the elements, on the timed rows'
# draws (the first seed). That share mostly counts the plain version's own
# rounding (its y lies 8-16x farther from the exact product than the
# kernel's), so on other draws it is reported, and the kernel is held to
# the exact pair instead, on every seed: the pair encoded from the f64
# product of the same x and integer codes. At each M, pooled over the
# (K, N), weight bits, seeds, x dtypes and pair bits, at most QOUT_SHARE of
# the kernel's codes differ from it (pooled over M's whole rows: a bf16
# absmax one ulp off moves a row's scale and with it up to ~15 % of its
# codes); over all draws, no more than the plain version's do
QOUT_MS = (2048, 128, 4)
QOUT_SHARE = 1e-4
QOUT_SEEDS = (11, 12, 13)
# the tied unembed: qmm_t of h (M, d_model) against the (vocab, d_model)
# table's codes — M 4 at decode, M 1 at each prefill's readout
UNEMBED_KN = (256000, 2048)
# [act-quant]: one 4 × 512 batch of the training path's TokenStream through
# layer 0 of full-width gemma-2b at int8; the 7 projections of the layer
# through ds_project; 32 draws of the gate pair within 5 standard errors of
# y; then 5 SGD steps of a full-width ds_mlp block (layer 0's bf16 weights,
# tanh GELU, target roll(x, 1)). lr 0.03: on the reference, over the same
# stream's rows (scripts/reference_ds_mlp_lr_sweep.py; ROADMAP holds the
# sweep), 0.3 and up diverge and 0.03 falls at every step
ACT = dict(batch=4, seq=512, draws=32, se=5.0, steps=5, lr=0.03)
# [check]: a reduced ds_mlp step card vs CPU (f32, 64 rows, d 64, d_ff 128)
ACT_CHECK_TOL = 1e-5          # rel to the largest gradient entry: sums reordered
# slice 7: full-width mamba2-780m through the legacy serve loop — 4 random
# prompts of 1024 tokens (4 chunks of 256, so the state carry runs at full
# width) and 32 new tokens, int8 weights, then the bf16 yardstick (bits 0)
MAMBA = dict(batch=4, prompt_len=1024, gen=32)
MAMBA_WIDTH = (48, 1536, 48, 64, 128)   # layers, d_model, SSM heads, head_dim, state
MAMBA_BITS = (8, 0)
# qmm at mamba2's int8 projections: (K, N) of in_proj and out_proj, at
# decode (M = batch) and the prefills of [serve-mamba] (M = B·S of the
# prompt, and of the prompt less its last token: the consistency check)
MAMBA_QMM_KN = ((1536, 6448, "in_proj"), (3072, 1536, "out_proj"))
MAMBA_QMM_MS = (4, 4 * 1024, 4 * 1023)
# ssd_chunk_scan (B12): ((B, NC, L, H, P, N), x/B/C dtype, initial state, role)
# — the prefill's 4 chunks of 256; the single 1023-row chunk that
# prefill(prompt[:, :-1]) runs (256 does not divide 1023); and that chunk at
# f32 with a non-zero initial state
SSD_CASES = [((4, 4, 256, 48, 64, 128), "bfloat16", False, "prefill, 4 chunks"),
             ((4, 1, 1023, 48, 64, 128), "bfloat16", False, "prefill of 1023, one chunk"),
             ((4, 4, 256, 48, 64, 128), "float32", False, "f32 prefill, 4 chunks"),
             ((4, 1, 1023, 48, 64, 128), "float32", False, "f32 prefill of 1023"),
             ((4, 1, 1023, 48, 64, 128), "float32", True, "f32, initial state")]
# rtol and atol: the reference's own for its Pallas kernel
# (tests/test_kernels.py): f32 sums in another order; at bf16 y rounds once more
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the final state, rtol and atol at both dtypes: bf16 x, B and C are exact
# tensor-core operands and the f32 ones split exactly into three bf16
# pieces, so only f32 rounding is left
SSD_STATE_TOL = 1e-4
# prefill(prompt[:, :-1]) + one decode_step against prefill(prompt)'s last
# logits at full width: within 2e-2 of the largest |logit|, gated at f32
# (f32 weights and activations), where the reference's own test of this
# bookkeeping runs it (tests/test_arch_smoke.py). At bf16 the gap is
# reported, not gated: the prefill sums the conv in bf16 and the decode in
# f32, and 1023 tokens make one chunk whose f32 cumulative log-decay loses
# digits in cum_l − cum_m, so on full-width mamba2-780m (48 layers, four
# 1024-token prompts, random weights) the reference itself parts there by
# 19 % of the largest logit at bf16 (1.83 of 9.51) and 5.9e-3 at f32, and
# two implementations of the same bf16 prefill part by as much (the port's
# and the reference's on one CPU: 2.28); scripts/reference_mamba_consistency.py
# --full --batch 4 --prompt 1024, ROADMAP
MAMBA_CONSISTENCY_TOL = 2e-2
MAMBA_CHECK_TOL = 1e-4        # [check] f32, card vs CPU plain path, of the largest |logit|
# slice 8: the rest of the dense family at full width (random weights, seed
# 0) through serve_engine on the [serve] trace — (layers, d_model, H, Hkv,
# D, d_ff, vocab) of each, as src/repro/configs/ has them — at weight/KV
# bits 8/8, qwen2.5-14b also at 4/4; and qwen2.5-14b through the legacy
# loop (ring KV cache of prompt + gen rows, attention in plain PyTorch)
DENSE_WIDTH = {"gemma-2b": (18, 2048, 8, 1, 256, 16384, 256000),
               "gemma-7b": (28, 3072, 16, 16, 256, 24576, 256000),
               "granite-3-8b": (40, 4096, 32, 8, 128, 12800, 49155),
               "qwen2.5-14b": (48, 5120, 40, 8, 128, 13824, 152064),
               "granite-moe-3b-a800m": (32, 1536, 24, 8, 64, 512, 49155),
               "mixtral-8x7b": (32, 4096, 32, 8, 128, 14336, 32000),
               "musicgen-medium": (48, 1536, 24, 24, 64, 6144, 2048)}
DENSE_ARCHS = ("gemma-7b", "granite-3-8b", "qwen2.5-14b")
DENSE_RUNS = (("gemma-7b", 8), ("granite-3-8b", 8), ("qwen2.5-14b", 8), ("qwen2.5-14b", 4))
LEGACY_DENSE = dict(arch="qwen2.5-14b", weight_bits=8, kv_bits=8, batch=4, prompt_len=32,
                    gen=16)
DENSE_BIAS_SEED = 5           # [check dense]: nonzero q/k/v biases, N(0, 0.25)
# slice 9: full-width zamba2-2.7b (the hybrid family) through the legacy
# serve loop — 4 random prompts of 1024 tokens, as [serve-mamba], and 16
# new tokens (32 before slice 12's depth cut), at weight/KV bits 8/8, 4/4
# and bf16/bf16; the shared block's six ring caches hold prompt + gen rows
HYBRID = dict(batch=4, prompt_len=1024, gen=16)
# layers, d_model, SSM heads, head_dim, state, shared_attn_every
HYBRID_WIDTH = (54, 2560, 80, 64, 64, 9)
HYBRID_BITS = (8, 4, 0)
# qmm at zamba2's projections: (K, N) of in_proj (N = 2·5120 + 2·64 + 80:
# a ragged last N tile), out_proj, the shared block's q/k/v/o, gate/up and
# down, at decode (M = batch) and the prefills (the prompt, and the prompt
# less its last token: the consistency check)
HYBRID_QMM_KN = ((2560, 10448, "in_proj"), (5120, 2560, "out_proj"),
                 (2560, 2560, "q, k, v, o"), (2560, 10240, "gate, up"),
                 (10240, 2560, "down"))
HYBRID_QMM_MS = (4, 4 * 1024, 4 * 1023)
# ssd_chunk_scan at zamba2's heads and state (H 80, N 64: half of phase
# 1's 128-wide state block): the prefill's 4 chunks of 256, the single
# 1023-row chunk, and f32 on the SIMT kernel with and without an initial
# state
HYBRID_SSD_CASES = [
    ((4, 4, 256, 80, 64, 64), "bfloat16", False, "zamba2 prefill, 4 chunks"),
    ((4, 1, 1023, 80, 64, 64), "bfloat16", False, "zamba2 prefill of 1023, one chunk"),
    ((4, 4, 256, 80, 64, 64), "float32", False, "zamba2 f32 prefill, 4 chunks"),
    ((4, 1, 1023, 80, 64, 64), "float32", False, "zamba2 f32 prefill of 1023"),
    ((4, 1, 1023, 80, 64, 64), "float32", True, "zamba2 f32, initial state")]
# prefill(prompt[:, :-1]) + one decode step against prefill(prompt) at
# full width, f32, both prefills reserving the decoded token's row in the
# shared caches (pad_to = prompt length): within HYBRID_CONSISTENCY_TOL of
# the largest |logit|. The reference itself parts there by 7.1e-3 of it on
# the CPU (0.0660 of 9.29, random weights from PRNGKey(0);
# scripts/reference_mamba_consistency.py --arch zamba2-2.7b --full --batch
# 4 --prompt 1024, ROADMAP): the gate leaves 2.8x that for the port's own
# rounding and weights, as [serve-mamba]'s 2e-2 left mamba2's 5.9e-3
HYBRID_CONSISTENCY_TOL = 2e-2
# [check hybrid]: (dtype, weight bits, KV bits) of each run, both sides fed
# the CPU's greedy tokens. f32 with raw KV rows is held to HYBRID_CHECK_TOL
# of the largest |logit|, card vs CPU plain path (slice 7's). With int KV,
# or at bf16, the logits' gap is reported and the greedy tokens must agree
# wherever the CPU's top two logits lie more than HYBRID_TIE of the largest
# apart, a little above the gap two correct runs show on an NVIDIA H100
# 80GB HBM3 (700 W): at f32, sums in another order put a KV row within
# noise of a rounding boundary and a code rounds one step apart (27 bytes
# and 1.46e-3 of the largest logit after 8 steps at 8/8); at bf16 the runs
# part by 8.7e-3 with raw KV rows, and at 8/8 the CPU's top two logits of
# one step lie 4.8e-4 of the largest apart (2e-2 is the CPU tests' bf16
# model tolerance)
HYBRID_CHECKS = (("float32", 0, 0), ("float32", 8, 0), ("float32", 4, 0),
                 ("float32", 8, 8), ("float32", 4, 4), ("bfloat16", 0, 0),
                 ("bfloat16", 8, 8), ("bfloat16", 4, 4))
HYBRID_CHECK_TOL = 1e-4
HYBRID_TIE = {"float32": 2e-3, "bfloat16": 2e-2}
# slice 10: full-width granite-moe-3b-a800m (32 layers, d_model 1536, 24
# query heads and 8 KV heads of 64, 40 experts of d_ff 512, top 8; random
# weights from seed 0) through serve_engine on the [serve] trace at
# weight/KV bits 8/8 and 4/4, and through the legacy serve (4 prompts of
# 1024: the prefill's 4096 tokens take the dispatch, capacity
# ⌊4096·8/40·1.25⌋ = 1024; 32 new tokens) at 8/8
MOE = "granite-moe-3b-a800m"
MOE_BITS = (8, 4)
MOE_LEGACY = dict(weight_bits=8, kv_bits=8, batch=4, prompt_len=1024, gen=32)
MOE_CAPACITY = int(4096 * 8 / 40 * 1.25)
# B5 at each (K, N) of the model — q and o, k and v (= an expert's gate and
# up), the router (N 40), an expert's down — at decode M 4, each prompt
# bucket of the trace and the decode profile's (64), the dispatch's
# capacity and the legacy prefill's M 4096
MOE_QMM_KN = {(1536, 1536): "q, o", (1536, 512): "k, v, expert gate, up",
              (1536, 40): "router", (512, 1536): "expert down"}
# [serve-moe]'s teacher-forced check: the cuda backend against the ref
# backend on the card, 4 prompts of 64 through the engine's own prefill and
# decode_logits, fed the ref backend's greedy tokens for MOE_FORCED_STEPS
# steps. The two differ at bf16 (ref rounds each decoded weight to bf16,
# B5 multiplies the exact codes and scales after). On the same input a
# router's choices may then differ only where its k-th and (k+1)-th
# probabilities lie within MOE_FORCED_ROUTE_TIE, which the run checks layer
# by layer (the ref backend's router on each input the cuda run's router
# saw): on an NVIDIA H100 80GB HBM3 at 700 W the largest such gap read
# 7.2e-4 at 8/8 (384 of 73728 choices apart; 3.3e-4 at 4/4, which the
# script no longer checks, for time). Along the
# runs each swapped expert moves the stream by far more than rounding, and
# at full width the two runs' routing parts more with every layer, so a
# token may differ where the ref's top two logits lie within
# HYBRID_TIE["bfloat16"] of the largest or after a routing difference of
# its sequence; those counts are reported
MOE_FORCED_STEPS = 4
# decode steps a moe profile covers: a step is 4000 qmm launches and ~12k
# device events, and torch.profiler takes ~10 s a step to read them back
MOE_PROFILE_STEPS = 1
MOE_FORCED_ROUTE_TIE = 2e-3
# [check moe]: the reduced model (8 experts, top 4) at f32, card kernels vs
# the CPU's plain path; a routing difference (an expert in one side's top k
# and not the other's) must sit where the CPU's k-th and (k+1)-th router
# probabilities lie within MOE_ROUTE_TIE: card and CPU sum the router's K
# in different orders, f32 noise of ~1e-7 in a probability (on an NVIDIA
# H100 80GB HBM3 at 700 W no choice differed at any of MOE_CHECKS)
MOE_CHECKS = ((0, 0), (8, 8), (4, 4))
MOE_CHECK_PROMPT = (2, 384)
MOE_ROUTE_TIE = 1e-4
# slice 11: full-width mixtral-8x7b (32 layers, d_model 4096, 32 query
# heads and 8 KV heads of 128, 8 experts of d_ff 14336, top 2, sliding
# window 4096, vocab 32000: 46.6 B parameters; random weights from seed 0,
# each weight encoded a layer at a time as it is drawn) through the legacy
# serve at weight/KV bits 8/8 and 4/4: 2 prompts of 8192 = 2 W (a multiple
# of the window longer than it: the only prompts on which the reference's
# ring holds the window, ROADMAP C24) and 32 new tokens. The prefill's
# 16384 tokens take the dispatch at capacity ⌊16384·2/8·1.25⌋ = 5120
MIXTRAL = "mixtral-8x7b"
MIXTRAL_BITS = (8, 4)
MIXTRAL_LEGACY = dict(batch=2, prompt_len=8192, gen=32)
MIXTRAL_WINDOW = 4096
MIXTRAL_CAPACITY = int(2 * 8192 * 2 / 8 * 1.25)
# B5 at each (K, N) of the model at decode M 2, the prefill's M 16384
# (q, k, v, o and the router: N 8, rows of 8 / 4 bytes) and the
# dispatch's capacity (the experts)
MIXTRAL_QMM_KN = {(4096, 4096): ("q, o", 16384), (4096, 1024): ("k, v", 16384),
                  (4096, 8): ("router", 16384),
                  (4096, 14336): ("expert gate, up", MIXTRAL_CAPACITY),
                  (14336, 4096): ("expert down", MIXTRAL_CAPACITY)}
# a layer's dispatch must keep most choices: with random weights and
# capacity factor 1.25 the drops are a few percent (granite-moe's ≤ 0.028)
MIXTRAL_DROP_MAX = 0.25
# [check window]: layers 0 and 31's attention of the int8 build at f32 on
# 8193 random rows: the ring prefill of 8192 + one decode step against the
# windowed block's last row, within WINDOW_CHECK_TOL of its largest |output|
# (f32 sums of 4096 rows in another order), and the unwindowed block's at
# least WINDOW_BINDS times that away
WINDOW_CHECK_LAYERS = (0, 31)
WINDOW_CHECK_TOL = 1e-4
WINDOW_BINDS = 100
# [check mixtral]: the reduced model (window 32) card vs CPU at f32, the
# legacy loop on 2 prompts of each length + 8 decode steps
MIXTRAL_CHECKS = ((0, 0), (8, 8))
MIXTRAL_CHECK_PROMPTS = (64, 40)
MIXTRAL_CHECK_TOL = 1e-5
# slice 12: full-width llama-3.2-vision-11b (40 layers, d_model 4096, 32
# query heads and 8 KV heads of 128, d_ff 14336, vocab 128256, rope θ 5e5;
# a cross-attention block after every 5 layers over 4096 vision tokens, 8
# in all; random weights from seed 0, each encoded a layer at a time as it
# is drawn) through make_prefill_step (pad_to = prompt + gen) and
# make_serve_step at weight/KV bits 8/8 and 4/4: 4 prompts of 1024 tokens
# (the reference's draw), 4096 vision stand-ins a prompt (f32 normal from a
# numpy seed, as the reference's tests/test_arch_smoke._batch draws them
# from its key), 32 new tokens
VLM = "llama-3.2-vision-11b"
VLM_BITS = (8, 4)
VLM_RUN = dict(batch=4, prompt_len=1024, gen=32)
VLM_WIDTH = (40, 4096, 32, 8, 128, 14336, 128256, 5, 4096)
VLM_VISION_SEED = 0
# B5 at each (K, N) of the model — q and o, k and v, gate and up, down — at
# decode M 4 and the prefill's M 4096, and the cross blocks' k and v of the
# vision tokens at M 4 × 4096
VLM_QMM_KN = {(4096, 4096): "q, o", (4096, 1024): "k, v", (4096, 14336): "gate, up",
              (14336, 4096): "down"}
VLM_CROSS_M = VLM_RUN["batch"] * 4096
# qmm launches: 7 a self layer and 4 a cross block a prefill (q of the
# prompt, k and v of the vision tokens, o), 7 and 2 (q, o) a decode step
VLM_QMM_PREFILL = 40 * 7 + 8 * 4
VLM_QMM_STEP = 40 * 7 + 8 * 2
# the cross caches: 8 blocks × k and v of (4, 4096, 8, 128) raw bf16
VLM_CROSS_BYTES = 8 * 2 * VLM_CROSS_M * 8 * 128 * 2
# [check cross]: cross blocks 0 and 7 of the int8 build at f32 on the
# stand-ins: the prefill's cross output at the last of 64 positions against
# _cross_decode's on the cached K/V, within CROSS_CHECK_TOL of the block's
# largest contribution (f32 sums of 4096 rows in another order)
CROSS_CHECK_BLOCKS = (0, 7)
CROSS_CHECK_TOL = 1e-4
# [check vlm]: the reduced model card vs CPU at f32, the legacy loop on 2
# prompts of 40 with seeded vision tokens + 8 decode steps
VLM_CHECKS = ((0, 0), (8, 8))
VLM_CHECK_TOL = 1e-5
# slice 12: full-width musicgen-medium (the audio family: 48 layers,
# d_model 1536, 24 MHA heads of 64, a gelu MLP of 6144, vocab 2048; random
# weights from seed 0) through serve_engine on the [serve] trace at
# weight/KV bits 8/8 and 4/4; B10 at its (24, 24, 64) layout (R 1, D 64)
AUDIO = "musicgen-medium"
AUDIO_BITS = (8, 4)
ATTN_AUDIO_LAYOUT = (24, 24, 64)
# [check audio]: (dtype, weight bits, KV bits) of each engine run, card vs
# CPU: raw KV at bf16 (B10 takes raw pages in bf16 alone), int at f32
AUDIO_CHECKS = (("bfloat16", 0, 0), ("float32", 8, 8), ("float32", 4, 4))
# depth cut to pay for slice 12's phases: the trace that [serve-dense] and
# [serve-moe] serve draws at most 16 new tokens a request, not 32 (its
# prompts, and so every prefill shape, are the same: make_trace draws each
# prompt's length before its budget and its tokens after), and
# [serve-dense]'s decode profile covers 2 steps
DEPTH_MAX_NEW = 16
DENSE_PROFILE_STEPS = 2
HYBRID_PROFILE_STEPS = 2
# slice 13: the engine's remaining features ([serve-features]) on
# full-width gemma-2b at weight/KV bits 8/8, page 16, 4 slots, random
# weights from seed 0, every engine at serve_engine's context (128 + 32 +
# 16 tokens); every run samples at temperature 0.8, top-k 40
FEAT_BITS = 8
FEAT_SAMPLE = dict(temperature=0.8, top_k=40)
FEAT_CHUNK_PAGES = 2
FEAT_CHUNK_M = FEAT_CHUNK_PAGES * SERVE["page_size"]   # a chunk's rows: B5's M, B10's B
FEAT_CONTEXT = SERVE["max_prompt"] + SERVE["max_new"] + SERVE["page_size"]
FEAT_LONG_PROMPT = 4096       # B10's check-only chunk row: a long prompt's last chunk
# the shared-prefix trace: 8 requests in 2 families, each a 64-token prefix
# (4 pages) + a private suffix of 8–40 tokens, 8–16 new tokens; the two
# family leaders (rids 0, 1) arrive first, the rest once they are prefilled
FEAT_PREFIX = dict(n_requests=8, families=2, prefix_len=64, suffix=(8, 40),
                   max_new=(8, 16), seed=13)
FEAT_MIN_HITS = 6
FEAT_SOLO = (2, 5)            # run 1's requests re-served alone
FEAT_NAN = dict(at_step=3, rid=1)          # run 4: one request's logits poisoned
FEAT_FLIP = dict(n_flips=3, seed=11)       # run 4: flips in a shared trie page
FEAT_RAISE_STEPS = (4, 5)                  # run 5: replica 0 raises at these set steps
FEAT_HEALTH = dict(step_deadline_s=1.0, dead_after=2, restart_backoff_s=0.1,
                   backoff_cap_s=0.5, max_restarts=2)
FEAT_PROFILE_STEPS = 3
# [check serve-features]: the reduced model at f32, 8/8, card against the
# CPU's plain path. A sampled token may part only where the CPU's two
# largest perturbed scores (logits / T + Gumbel noise) lie within
# FEAT_SAMPLE_TIE of each other (f32 sums in another order move a logit by
# ~1e-6 of its size)
FEAT_SAMPLE_TIE = 1e-3
# its shared-prefix trace: 8 requests, 2 families of a 16-token prefix (2
# pages of 8) + 2–10 tokens, 8–16 new
FEAT_CHECK = dict(n_requests=8, families=2, prefix_len=16, suffix=(2, 10), max_new=(8, 16),
                  seed=13)


def _fail(msg: str, code: int):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(code)


def _timed(fn, flush, iters: int = 20) -> float:
    """Median device time of ``fn`` in ms (CUDA events), with the L2 cache
    flushed before every launch: on the serving path each weight matrix is
    streamed once per step, so the cache is cold."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


@contextlib.contextmanager
def _uncounted():
    """Threefry launches made inside (timings, profiles after a path's run)
    count for no path: the plane kernel's counters are put back after."""
    from repro_torch.kernels import threefry as TF

    saved, n = collections.Counter(TF.shape_launches), TF.launches
    try:
        yield
    finally:
        TF.shape_launches.clear()
        TF.shape_launches.update(saved)
        TF.launches = n


def _warm_up(dev, seconds: float = 5.0):
    """Keep the card busy with bf16 matmuls for ``seconds`` before the first
    timed row: in a fresh process the first rows (decode M 4) read up to
    twice their steady times without it, in any version of the kernel."""
    import torch

    a = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        a @ a
        torch.cuda.synchronize()


def _bound(nbytes: int, ops: int, peak: float = BF16_FLOPS, *more):
    """The least time (ms) for ``nbytes`` of HBM traffic and ``ops`` at
    ``peak`` ops/s (and each further (ops, peak) pair, on pipes of their
    own): the largest of those times, and which bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(o / pk * 1e3 for o, pk in ((ops, peak), *more))
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _int32_rate() -> float:
    """The card's int32 rate (ops/s): INT32_PER_CLK_SM × SMs × the maximum
    SM clock nvidia-smi reports."""
    import torch

    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_PER_CLK_SM * sms * mhz * 1e6


def _core_gate(what: str, mod, checked=None) -> dict:
    """Fail unless every launch of ``mod`` (``qmm`` or ``qmm_qout``) since
    its counters were reset ran on the core that ``qmm.plan`` gives bf16 x
    (every main path's activations) at its shape and, given the
    (packed, M, K, N) keys of the checked rows, at a shape that a row held
    against the plain version; returns the per-core counts."""
    import torch
    from repro_torch.kernels import qmm as Q

    name = mod.__name__.rsplit('.', 1)[-1]
    if checked is not None:
        unchecked = set(mod.shape_launches) - set(checked)
        if unchecked:
            raise AssertionError(f"{what}: {name} launched at unchecked shapes "
                                 f"{sorted(unchecked)}")
    tc = sum(c for (packed, m, k, n), c in mod.shape_launches.items()
             if Q.plan(m, k, n, torch.bfloat16).core == "tc")
    got = {"simt": mod.simt_launches, "tc": mod.tc_launches}
    if got != {"simt": mod.launches - tc, "tc": tc}:
        raise AssertionError(f"{what}: {name} launches by core {got}, plan gives tc {tc} "
                             f"of {mod.launches}")
    return got


def _qmm_row(dev, gen, flush, bits, m, k, n, role=""):
    """``qmm`` against its plain version at one shape (int8 or packed int4
    codes of a random weight, bf16 x): checked within ``QMM_TOL`` and
    timed beside the plain version, the bf16 matmul and the bound."""
    import torch
    from repro_torch.kernels import qmm as Q
    from repro_torch.quant import QScheme, encode

    packed = bits == 4
    w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
    qt = encode(w, QScheme.int_symmetric(bits, scaling="channel",
                                         rounding="nearest", packed=packed))
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    core = Q.plan(m, k, n, x.dtype).core
    before = {"simt": Q.simt_launches, "tc": Q.tc_launches}
    got = Q.qmm(x, qt.codes, qt.scale, packed=packed)
    ran = {"simt": Q.simt_launches - before["simt"], "tc": Q.tc_launches - before["tc"]}
    if ran != {c: int(c == core) for c in ran}:
        raise AssertionError(f"qmm int{bits} {m}x{k}x{n}: planned core {core}, ran {ran}")
    want = Q.qmm_plain(x, qt.codes, qt.scale, packed=packed)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ref_max = float(want.abs().max())
    if not err <= QMM_TOL * ref_max:
        raise AssertionError(f"qmm int{bits} {m}x{k}x{n} ({core}): max err {err} "
                             f"> {QMM_TOL} x {ref_max}")
    w_bf16 = qt.decode().to(torch.bfloat16)
    ms = _timed(lambda: Q.qmm(x, qt.codes, qt.scale, packed=packed), flush)
    plain_ms = _timed(lambda: Q.qmm_plain(x, qt.codes, qt.scale, packed=packed), flush)
    lib_ms = _timed(lambda: torch.matmul(x, w_bf16), flush)
    nbytes = x.numel() * 2 + qt.codes.numel() + n * 4 + m * n * 4
    # x is bf16 and bf16 holds every int8 code exactly; the per-column
    # scale comes after the contraction, so one bf16 tensor-core GEMM
    # with f32 accumulation computes the same function: the bf16 rate
    bound_ms, bound_by = _bound(nbytes, 2 * m * k * n)
    print(f"[kernel] qmm int{bits} (M,K,N)=({m},{k},{n}){role}: core={core} "
          f"max_err={err:.3e} (tol {QMM_TOL:g} x {ref_max:.3g}) kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by})", flush=True)
    return {"name": f"qmm int{bits} M{m} K{k} N{n}{role}", "key": (packed, m, k, n),
            "core": core, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def check_qmm(dev, flush):
    """``qmm`` at every shape that gemma-2b's paths launch — decode (M 4),
    the training batch (M 2048), and each prompt bucket of the served
    trace (the prefill's M) — at q/o, k/v, gate/up and down, plus gate/up
    at M 128 (the largest bucket there can be) and at the two sides of
    plan's threshold; int8 and packed int4."""
    import torch
    from repro_torch.kernels import qmm as Q

    edge = Q.TC_THRESHOLD
    shapes = {(m, k, n): " (prefill, bucket 128)" if m == SERVE["max_prompt"] else ""
              for m, k, n in QMM_SHAPES}
    for m in sorted(_prompt_buckets()):
        for k, n in QBP_KN:
            shapes[(m, k, n)] = f" (prefill, bucket {m})"
    for m in (edge, edge + 1):
        shapes[(m, 2048, 16384)] = f" (threshold {edge}, {'above' if m > edge else 'at'})"
    rows = []
    gen = torch.Generator(device=dev).manual_seed(1)
    for bits in (8, 4):
        for (m, k, n), role in shapes.items():
            rows.append(_qmm_row(dev, gen, flush, bits, m, k, n, role))
    return rows


def check_qmm_ssm(dev, flush, arch="mamba2-780m"):
    """``qmm`` at the int projections of the legacy loop's Mamba2 models, at
    decode (M = batch, the SIMT core) and at the prefills of their serve
    phase (M = B·S of the prompt and of the prompt less its last token, the
    tensor cores): mamba2-780m's in_proj (K 1536, N 6448: N not a multiple
    of 64) and out_proj (K 3072, N 1536), int8; zamba2-2.7b's
    ``HYBRID_QMM_KN`` (in_proj's N 10448 leaves a ragged last tile), int8
    and packed int4."""
    import torch

    kn, ms, bits_list, seed, model = {
        "mamba2-780m": (MAMBA_QMM_KN, MAMBA_QMM_MS, (8,), 11, "mamba2"),
        "zamba2-2.7b": (HYBRID_QMM_KN, HYBRID_QMM_MS, (8, 4), 13, "zamba2")}[arch]
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for bits in bits_list:
        for m in ms:
            for k, n, what in kn:
                rows.append(_qmm_row(dev, gen, flush, bits, m, k, n, f" ({model} {what})"))
    return rows


def _dense_kn(arch: str) -> dict:
    """(K, N) → projections of ``arch``'s seven matmuls a layer."""
    from repro_torch import configs

    cfg = configs.get_config(arch)
    d, q, kv, ff = cfg.d_model, cfg.n_heads * cfg.head_dim, \
        cfg.n_kv_heads * cfg.head_dim, cfg.d_ff
    out = {}
    for k, n, what in ((d, q, "q"), (d, kv, "k, v"), (q, d, "o"), (d, ff, "gate, up"),
                       (ff, d, "down")):
        out[(k, n)] = f"{out[(k, n)]}, {what}" if (k, n) in out else what
    return out


def check_qmm_dense(dev, flush):
    """``qmm`` at every projection of slice 8's models (gemma-7b,
    granite-3-8b, qwen2.5-14b), int8 and int4, at decode M 4 and at each
    prompt bucket of the trace [serve-dense] serves them, and at
    qwen2.5-14b's legacy prefill (M = batch × prompt, int8)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(12)
    legacy_m = LEGACY_DENSE["batch"] * LEGACY_DENSE["prompt_len"]
    rows = []
    for arch in DENSE_ARCHS:
        ms = {SERVE["max_slots"]: "decode"}
        for m in sorted(_prompt_buckets(arch)):
            ms[m] = f"prefill, bucket {m}"
        for bits in (8, 4):
            legacy = arch == LEGACY_DENSE["arch"] and bits == LEGACY_DENSE["weight_bits"]
            cases = {**ms, legacy_m: "legacy prefill"} if legacy else ms
            for (k, n), what in _dense_kn(arch).items():
                for m, role in cases.items():
                    rows.append(_qmm_row(dev, gen, flush, bits, m, k, n,
                                         f" ({arch} {what}; {role})"))
    return rows


def _attn_pool(dev, gen, bits, n_pages, page, hkv, d):
    """One layer of a paged KV pool at ``bits`` holding random rows."""
    import torch
    from repro_torch.serve import pages as pg

    pool = pg.init_pool(1, n_pages, page, hkv, d, kv_bits=bits, device=dev)
    k = torch.randn(n_pages, page, hkv, d, generator=gen, device=dev)
    v = torch.randn(n_pages, page, hkv, d, generator=gen, device=dev)
    kc, ks = pg.quant_rows(k, bits)
    vc, vs = pg.quant_rows(v, bits)
    kp, vp, ksc, vsc = pool.layer(0)
    kp.copy_(kc)
    vp.copy_(vc)
    if bits:
        ksc.copy_(ks)
        vsc.copy_(vs)
    return kp, vp, ksc, vsc


def _attn_row(flush, args, bits, path, shared=False):
    """Check one ``paged_decode_attn`` call against its plain version
    (ATTN_TOL) and every row of it against the same row computed alone
    (bit-equal), then time it beside the plain version and SDPA.
    ``shared``: every query is a position of one sequence on one block
    table (a prefill chunk), so the bound reads that sequence's rows once
    (max(lens) of them) and the yardstick is one SDPA of the B queries over
    its gathered context, query i masked to its first lens[i] rows."""
    import torch
    from repro_torch.kernels import paged_attn as PA
    from repro_torch.kernels.ref import dequant_pages_ref, gather_pages_ref

    q, kp, vp, ksc, vsc, bt, lens = args
    b, h, d = q.shape
    page, hkv = kp.shape[1], kp.shape[2]
    lens_l = lens.tolist()
    name = {0: "bf16", 8: "int8", 4: "int4"}[bits]
    label = f"paged_decode_attn {name} B{b} H{h} Hkv{hkv} D{d} page{page}"
    if not path:
        label += f" lens{lens_l} (check only)"
    kw = dict(softmax_scale=d ** -0.5, kv_bits=bits)
    got = PA.paged_decode_attn(*args, **kw)
    want = PA.paged_decode_attn_plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= ATTN_TOL:
        raise AssertionError(f"{label}: max err {err} > {ATTN_TOL}")
    # a row's bits depend on its own length alone (decode and the verify
    # window must agree)
    for i in range(b):
        alone = PA.paged_decode_attn(q[i:i + 1], kp, vp, ksc, vsc, bt[i:i + 1], lens[i:i + 1],
                                     **kw)
        if not torch.equal(alone[0], got[i]):
            raise AssertionError(f"{label}: row {i} (len {lens_l[i]}) differs from "
                                 "the same row computed alone")
    # library yardstick: SDPA over the gathered, dequantized rows, each kv
    # head repeated for its H / Hkv query heads
    bt_lib = bt[:1] if shared else bt
    kk = dequant_pages_ref(gather_pages_ref(kp, bt_lib),
                           gather_pages_ref(ksc, bt_lib) if bits else None)
    vv = dequant_pages_ref(gather_pages_ref(vp, bt_lib),
                           gather_pages_ref(vsc, bt_lib) if bits else None)
    t_all, nb = kk.shape[1], kk.shape[0]

    def heads(x):
        x = x.to(torch.bfloat16).permute(0, 2, 1, 3)[:, :, None]
        return x.expand(nb, hkv, h // hkv, t_all, d).reshape(nb, h, t_all, d).contiguous()

    kk, vv = heads(kk), heads(vv)
    mask = torch.arange(t_all, device=q.device)[None, :] < lens[:, None]
    if shared:      # (1, H, B, D) queries, (1, 1, B, T) mask
        mask, q4 = mask[None, None], q.permute(1, 0, 2)[None]
    else:           # (B, H, 1, D) queries, (B, 1, 1, T) mask
        mask, q4 = mask[:, None, None, :], q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = _timed(lambda: PA.paged_decode_attn(*args, **kw), flush)
    plain_ms = _timed(lambda: PA.paged_decode_attn_plain(*args, **kw), flush)
    lib_ms = _timed(lambda: sdpa(q4, kk, vv, attn_mask=mask), flush)
    rows_kv = int(lens.sum())
    rows_read = int(lens.max()) if shared else rows_kv
    row_bytes = {0: d * 2, 8: d + 4, 4: d // 2 + 4}[bits]
    nbytes = q.numel() * q.element_size() + 2 * rows_read * hkv * row_bytes + bt.numel() * 4 \
        + b * 4 + b * h * d * 4
    bound_ms, bound_by = _bound(nbytes, 4 * rows_kv * h * d)
    print(f"[kernel] {label} lens={lens_l}: max_err={err:.3e} (tol {ATTN_TOL:g}), rows "
          f"bit-equal alone; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
          f"bound_ms={bound_ms:.5f} ({bound_by})", flush=True)
    return {"name": label, "kv_bits": bits, "path": path, "layout": (h, hkv, d),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "rows_bit_equal_alone": True}


def check_paged_attn(dev, flush):
    """B10 at gemma-2b's serving shape and at slice 8's head layouts (the
    paths' rows: [serve] and [serve-dense]), then check-only long rows."""
    import torch

    b, h, hkv, d, page = 4, 8, 1, 256, 16
    maxp = -(-max(ATTN_LENS) // page) + 1
    n_pages = b * maxp + 1
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(b, h, d, generator=gen, device=dev).to(torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)[: b * maxp] + 1
    bt = perm.reshape(b, maxp).to(torch.int32)
    lens = torch.tensor(ATTN_LENS, dtype=torch.int32, device=dev)
    rows = []
    for bits in (0, 8, 4):
        pool = _attn_pool(dev, gen, bits, n_pages, page, hkv, d)
        rows.append(_attn_row(flush, (q, *pool, bt, lens), bits, True))
    gen = torch.Generator(device=dev).manual_seed(3)
    for layout, case_lens in [*((lay, ATTN_LENS) for lay in ATTN_DENSE_LAYOUTS),
                              ((8, 1, 256), ATTN_LONG_LENS)]:
        rows += _attn_layout_rows(dev, flush, gen, layout, case_lens,
                                  layout in ATTN_DENSE_LAYOUTS)
    return rows


def _attn_layout_rows(dev, flush, gen, layout, case_lens, path, b=4, page=16):
    """B10 rows at one (H, Hkv, D) layout, KV bits 0, 8 and 4, one row of
    ``case_lens`` per sequence on shuffled pages."""
    import torch

    h, hkv, d = layout
    maxp = -(-max(case_lens) // page) + 1
    n_pages = b * maxp + 1
    q = torch.randn(b, h, d, generator=gen, device=dev).to(torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)[: b * maxp] + 1
    bt = perm.reshape(b, maxp).to(torch.int32)
    lens = torch.tensor(case_lens, dtype=torch.int32, device=dev)
    rows = []
    for bits in (0, 8, 4):
        pool = _attn_pool(dev, gen, bits, n_pages, page, hkv, d)
        rows.append(_attn_row(flush, (q, *pool, bt, lens), bits, path))
    return rows


def check_paged_attn_moe(dev, flush):
    """B10 at granite-moe-3b-a800m's layout (24 query heads, 8 KV heads of
    64: D 64 and R 3, which no earlier path ran) at ``ATTN_LENS``, KV bits
    0, 8 and 4: [serve-moe]'s rows."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(4)
    return _attn_layout_rows(dev, flush, gen, ATTN_MOE_LAYOUT, ATTN_LENS, True)


def _width(cfg) -> tuple:
    return (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size)


def _qmm_per_layer(cfg) -> int:
    """``qmm`` launches a layer makes in one forward of an int model: q, k,
    v, o and gate, up, down; an moe layer's q, k, v, o, the router and
    gate, up, down of each expert (one launch a slice)."""
    return 4 + 1 + 3 * cfg.n_experts if cfg.family == "moe" else 7


def serve(bits: int, dev, checked, arch: str = "gemma-2b", tag: str = "serve", extra=None,
          profile_steps: int = 5, max_new: int = SERVE["max_new"]):
    """Drive the main path once: ``serve_engine`` on full-width ``arch`` at
    weight/KV bits ``bits`` on the slice-1 trace (its requests' budgets
    drawn up to ``max_new``; the prompts do not depend on it); fail if ``qmm`` launched
    at a shape outside ``checked`` (the checked rows' keys); returns
    (launch counts, qmm shape counts, summary). The summary's peak is the
    card's allocation peak over the call (weights drawn in bf16 and
    quantized included) above what was allocated before it. ``extra``,
    given, is called on the engine after the run and the decode profile
    (over ``profile_steps`` steps), and its dict joins the summary."""
    import torch
    from repro_torch.kernels import paged_attn as PA
    from repro_torch.kernels import qmm as Q
    from repro_torch.launch.serve import serve_engine

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    Q.reset_counters()
    PA.launches = 0
    t0 = time.perf_counter()
    engine, results = serve_engine(
        arch, reduced=False, weight_bits=bits, kv_bits=bits, device=dev,
        **{**SERVE, "max_new": max_new})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = {"qmm": Q.launches, "paged_decode_attn": PA.launches}
    shapes = dict(Q.shape_launches)
    qmm_cores = _core_gate(f"[{tag}] {arch} {bits}/{bits}", Q, checked)
    cfg, st = engine.cfg, engine.stats
    if _width(cfg) != DENSE_WIDTH[arch]:
        raise AssertionError(f"not full-width {arch}: {cfg}")
    if len(results) != 8 or st["finished"] != 8:
        raise AssertionError(f"{len(results)} of 8 requests finished")
    engine.allocator.check_leaks(0)
    n_gen = 0
    for f in results.values():
        gen = f.tokens[f.prompt_len:]
        if len(gen) != f.n_generated or f.n_generated < 1:
            raise AssertionError(f"request {f.rid}: {f.n_generated} tokens")
        if gen.min() < 0 or gen.max() >= cfg.vocab_size:
            raise AssertionError(f"request {f.rid}: token out of vocab")
        n_gen += f.n_generated
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    per_step_qmm = _qmm_per_layer(cfg) * cfg.n_layers
    want_qmm = per_step_qmm * (st["decode_steps"] + st["admitted"])
    want_attn = cfg.n_layers * st["decode_steps"]
    if launches["qmm"] != want_qmm or launches["paged_decode_attn"] != want_attn:
        raise AssertionError(f"launches {launches}, expected qmm {want_qmm} "
                             f"and paged_decode_attn {want_attn}")
    summary = {"weight_bits": bits, "kv_bits": bits, "requests_finished": len(results),
               "tokens_generated": n_gen, "decode_steps": st["decode_steps"],
               "prefill_tokens": st["prefill_tokens"],
               "decode_tokens_per_s": engine.throughput(),
               "mean_decode_step_ms": 1e3 * statistics.mean(engine.decode_times),
               "kv_pool_bytes": engine.kv_pool_nbytes(),
               "weight_bytes": engine.weight_nbytes(), "wall_s": wall,
               "peak_bytes": peak, "arch": arch,
               "attn_layout": (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
               "launches": launches, "qmm_launches_by_core": qmm_cores,
               "launches_per_decode_step": {"qmm": per_step_qmm,
                                            "paged_decode_attn": cfg.n_layers}}
    print(f"[{tag}] {arch} full width, weight/kv bits {bits}/{bits}: "
          f"{len(results)} requests finished, {n_gen} tokens generated in "
          f"{st['decode_steps']} decode steps (+{st['prefill_tokens']} prefill tokens); "
          f"steady-state decode {summary['decode_tokens_per_s']:.1f} tok/s "
          f"({summary['mean_decode_step_ms']:.2f} ms/step); KV pool "
          f"{summary['kv_pool_bytes']:,} bytes; weights {summary['weight_bytes']:,} bytes; "
          f"peak {peak / 2**30:.2f} GiB; launches qmm={launches['qmm']} {qmm_cores} "
          f"paged_decode_attn={launches['paged_decode_attn']}", flush=True)
    summary["profile"] = profile_decode(engine, profile_steps)
    if extra is not None:
        summary.update(extra(engine))
    del engine
    torch.cuda.empty_cache()
    return launches, shapes, summary


def _device_kernels(prof):
    """Device time by kernel (ms, names cut to 60 characters and summed) and
    the number of device events of a ``torch.profiler`` run."""
    from torch.autograd import DeviceType

    by_kernel, n_events = {}, 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:      # device-side events only
            continue
        n_events += ev.count
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us:
            name = ev.key[:60]
            by_kernel[name] = by_kernel.get(name, 0.0) + dev_us / 1e3
    return by_kernel, n_events


def profile_window(advance, steps: int, what: str):
    """``torch.profiler`` over ``steps`` calls of ``advance()`` (one decode
    step or speculative window each): device time by kernel, and the
    device's idle share of the window's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            advance()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel, n_kernels = _device_kernels(prof)
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_events_per_step": n_kernels / steps,
           "device_ms_per_step": device_ms / steps if device_ms else None,
           "device_idle_share": 1 - device_ms / wall_ms if device_ms else None,
           "top_kernels_ms_per_step": {k: v / steps for k, v in top},
           "paged_attn_ms_per_step": sum(v for k, v in by_kernel.items()
                                         if "paged_attn" in k) / steps}
    if device_ms:
        print(f"[profile] {steps} {what}: wall {out['wall_ms_per_step']:.2f} "
              f"ms/step, {out['device_events_per_step']:.0f} device events/step, device busy "
              f"{out['device_ms_per_step']:.3f} ms/step, idle share "
              f"{out['device_idle_share']:.3f}, paged attention "
              f"{out['paged_attn_ms_per_step']:.4f} ms/step; top: " + "; ".join(
                  f"{k[:40]} {v:.3f}" for k, v in out["top_kernels_ms_per_step"].items()),
              flush=True)
    else:
        print("[profile] torch.profiler recorded no device time: not measured", flush=True)
    return out


def profile_decode(engine, steps: int = 5, what: str = "decode steps"):
    """Where a decode step's time goes: ``profile_window`` over ``steps``
    steady decode steps (speculative windows on a speculative engine) of 4
    live requests."""
    from repro_torch.launch.serve import make_trace

    for r in make_trace(4, engine.cfg.vocab_size, max_new=steps + 4,
                        min_prompt=64, max_prompt=64, seed=7):
        engine.submit(r)
    engine.step()                                  # admit all four + one decode
    out = profile_window(engine.step, steps, f"{what} x 4 live slots")
    while engine.busy:
        engine.step()
    return out


def agree_small(dev):
    """The reduced model at f32 on the card (kernels) against the same
    engine's plain path on the CPU: the first generated token of every
    request must agree; the full-sequence agreement is reported."""
    import torch
    from repro_torch import configs
    from repro_torch.launch.serve import make_trace
    from repro_torch.models import transformer as T
    from repro_torch.precision.qat import quantize_param_tree
    from repro_torch.quant import PrecisionPlan
    from repro_torch.serve import ServeEngine

    out = {}
    for bits in (8, 4):
        plan = PrecisionPlan(model_bits=bits, kv_bits=bits, model_storage="int")
        cfg = configs.get_reduced("gemma-2b", dtype=torch.float32, precision=plan)
        params = quantize_param_tree(T.init_params(cfg, seed=0, device="cpu"), bits=bits)
        res = {}
        for where in (dev, "cpu"):
            eng = ServeEngine(params, cfg, max_slots=4, page_size=8, max_seq_len=56,
                              backend="cuda", device=where)
            res[str(where)] = eng.run(make_trace(8, cfg.vocab_size, max_new=16,
                                                 max_prompt=32, seed=0))
        on_card, on_cpu = res[str(dev)], res["cpu"]
        first = sum(int(on_card[r].tokens[on_card[r].prompt_len]
                        == on_cpu[r].tokens[on_cpu[r].prompt_len]) for r in on_cpu)
        same = sum(int((on_card[r].tokens == on_cpu[r].tokens).all()) for r in on_cpu)
        if first != 8:
            raise AssertionError(f"reduced gemma-2b int{bits}: first tokens agree "
                                 f"on {first} of 8 requests (card vs CPU plain path)")
        out[bits] = {"first_tokens_equal": first, "sequences_equal": same}
        print(f"[check] reduced gemma-2b f32 int{bits}: card kernels vs CPU plain path — "
              f"first tokens equal {first}/8, whole sequences equal {same}/8", flush=True)
    return out


def _tf_keys(k, seed):
    from repro_torch import prng

    return prng.PRNGKey(seed) if k == 1 else prng.split(prng.PRNGKey(seed), k)


def check_threefry(dev, flush):
    """The threefry plane kernel against its plain version (the int64 path,
    on the card): bit-exact at every ``TF_CHECKS`` case (int32, int64 and
    f32 output; one key and batched keys; ragged n; windows across 2³²),
    then the ``TF_ROWS`` rows (:func:`threefry_rows`)."""
    import torch
    from repro_torch.kernels import threefry as TF

    for out, k, shape, start in TF_CHECKS:
        key = _tf_keys(k, len(shape) + k + start % 97)
        got = TF.threefry_plane(key, shape, out=out, start=start, device=dev)
        want = TF.threefry_plane_plain(key, shape, out=out, start=start, device=dev)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"threefry {out} keys {k} {shape} start {start}: "
                                 f"{int((got != want).sum())} words differ from the int64 path")
    print(f"[kernel] threefry: bit-exact with the int64 path at {len(TF_CHECKS)} cases "
          f"(int32/int64/f32, 1/3/180 keys, ragged n, windows across 2^32)", flush=True)
    return threefry_rows(dev, flush, TF_ROWS)


def threefry_rows(dev, flush, specs):
    """One row for each (out, keys, shape) of ``specs``: the plane kernel
    bit-exact with its plain version (the int64 path, on the card), timed
    beside it and the bound max(bytes written / HBM rate, HASH_ALU_OPS per
    word / the int32 rate, HASH_OPS per word / twice it). No PyTorch call
    computes threefry2x32 (library "—"). A row's key is the kernel's
    ``shape_launches`` key (out, keys, n): the kernel sees a plane as n flat
    counters a key, whatever its shape."""
    import torch
    from repro_torch.kernels import threefry as TF

    rows = []
    for out, k, shape in specs:
        key = _tf_keys(k, 7)
        n = int(np.prod(shape))
        got = TF.threefry_plane(key, shape, out=out, device=dev)
        iters = 3 if k * n > 1 << 24 else 20
        want = TF.threefry_plane_plain(key, shape, out=out, device=dev)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"threefry {out} keys {k} {shape}: differs from the int64 path")
        del got, want
        ms = _timed(lambda: TF.threefry_plane(key, shape, out=out, device=dev), flush)
        plain_ms = _timed(lambda: TF.threefry_plane_plain(key, shape, out=out, device=dev),
                          flush, iters=iters)
        words = k * n
        nbytes = words * (8 if out == "int64" else 4) + (16 * k if k > 1 else 0)
        bound_ms, bound_by = _bound(nbytes, HASH_ALU_OPS * words, INT32_OPS,
                                    (HASH_OPS * words, 2 * INT32_OPS))
        keys = f"{k} keys × " if k > 1 else ""
        rows.append({"name": f"threefry {out} {keys}{'x'.join(map(str, shape))}",
                     "key": (out, k, n), "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"[kernel] threefry {out} {keys}{shape}: bit-exact kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} (int64 path) library_ms=— bound_ms={bound_ms:.5f} "
              f"({bound_by}: {nbytes} bytes at 3.35 TB/s; {HASH_ALU_OPS} shifts and xors a "
              f"word at {INT32_OPS / 1e12:.3f} T/s, all {HASH_OPS} int32 ops at twice that)",
              flush=True)
        torch.cuda.empty_cache()
    return rows


def check_ds_quant(dev, flush):
    """``ds_quant`` against its plain version: the rand entry bit-exact for
    every case at ``DS_S`` and the case's own s, the keyed entry bit-exact
    with the rand entry on the key's ``prng.bits`` plane there too; both
    timed at the case's s. The keyed entry's plain version draws the plane
    by the int64 path; its bound counts 6 bytes an element and the hash's
    int32 operations."""
    import torch
    from repro_torch import prng
    from repro_torch.kernels import stoch_quant as SQ
    from repro_torch.kernels import threefry as TF

    rows = []
    gen = torch.Generator(device=dev).manual_seed(3)
    for r, c, axis, s_case in DS_CASES:
        x = torch.randn(r, c, generator=gen, device=dev) * 2
        a = x.abs()
        scale = a.amax(0, keepdim=True) if axis == "col" else a.amax(1, keepdim=True)
        key = prng.PRNGKey(r + c)
        rand = prng.bits(key, (r, c), device=dev, dtype=torch.int32)
        checked = sorted({*DS_S, s_case})
        for s in checked:
            got = SQ.ds_quant(x, rand, scale, s=s, scale_axis=axis)
            want = SQ.ds_quant_plain(x, rand, scale, s=s)
            keyed = SQ.ds_quant_keyed(x, key, scale, s=s, scale_axis=axis)
            torch.cuda.synchronize()
            diff = sum(int((g != w).sum()) for g, w in zip(got, want))
            diff_k = sum(int((g != w).sum()) for g, w in zip(keyed, want))
            if diff or diff_k:
                raise AssertionError(f"ds_quant ({r},{c}) {axis} s={s}: {diff} codes (rand "
                                     f"entry), {diff_k} (keyed) differ from the plain "
                                     "version (must be bit-exact)")
        s = s_case
        ms = _timed(lambda: SQ.ds_quant(x, rand, scale, s=s, scale_axis=axis), flush)
        plain_ms = _timed(lambda: SQ.ds_quant_plain(x, rand, scale, s=s), flush)
        keyed_ms = _timed(lambda: SQ.ds_quant_keyed(x, key, scale, s=s, scale_axis=axis), flush)
        keyed_plain_ms = _timed(lambda: SQ.ds_quant_plain(
            x, TF.threefry_plane_plain(key, (r, c), out="int32", device=dev), scale, s=s),
            flush, iters=5)
        for keyed_row, k_ms, p_ms, per_elem in ((False, ms, plain_ms, 10),
                                                (True, keyed_ms, keyed_plain_ms, 6)):
            nbytes = per_elem * r * c + scale.numel() * 4
            more = [(HASH_ALU_OPS * r * c, INT32_OPS)] if keyed_row else []
            bound_ms, bound_by = _bound(nbytes, 20 * r * c, F32_FLOPS, *more)
            entry = "keyed " if keyed_row else ""
            rows.append({"name": f"ds_quant {entry}f32 R{r} C{c} {axis}-scaled s{s}",
                         "key": (r, c, axis, keyed_row), "max_abs_err": 0.0, "ms": k_ms,
                         "plain_ms": p_ms, "library_ms": None, "bound_ms": bound_ms,
                         "bound_by": bound_by})
            print(f"[kernel] ds_quant {entry}(R,C)=({r},{c}) {axis}-scaled: bit-exact at "
                  f"s={checked} kernel_ms={k_ms:.4f} (s={s}) plain_ms={p_ms:.4f}"
                  f"{' (int64 plane + plain)' if keyed_row else ''} bound_ms={bound_ms:.5f} "
                  f"({bound_by}, {nbytes} bytes at 3.35 TB/s"
                  f"{f', {HASH_ALU_OPS} int32 shifts and xors an element' if keyed_row else ''})",
                  flush=True)
    return rows


def _cuda_launches(fn, calls: int = 5) -> tuple[float, list[str]]:
    """Device events (kernels and memsets alike) per call of ``fn``, over
    ``calls`` calls under ``torch.profiler``, after a warm-up call. The
    profiler records a second round of ``calls`` calls after a first it
    discards: CUPTI coming up late drops the first events of a profile (4
    of 5 calls' launches were seen, three profiles in a row, on an NVIDIA
    H100 80GB HBM3). A profile that records no device event at all, or a
    count of events that ``calls`` calls cannot make, is a failed reading
    and is taken again, at most twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if events and sum(e.count for e in events) % calls == 0:
            break
    return sum(e.count for e in events) / calls, [e.key[:60] for e in events]


def check_qmv(dev, flush):
    """``qmv`` kernel against its plain version (rel 1e-5 of the largest
    output), on planes and on their transposed views, run-to-run identical;
    ``torch.mv`` on codes pre-converted to f32 is the library yardstick.
    Then, every row timed (a profiler session slows the launches timed
    after it), one CUDA launch per call at every row (``torch.profiler``:
    no second kernel, no memset)."""
    import torch
    from repro_torch.kernels import qmv as QV

    rows, calls = [], []
    gen = torch.Generator(device=dev).manual_seed(4)
    for r, c, transposed in QMV_CASES:
        plane = torch.randint(-127, 128, (r, c), generator=gen, device=dev,
                              dtype=torch.int8)
        codes = plane.T if transposed else plane
        rr, cc = codes.shape
        v = torch.randn(cc, generator=gen, device=dev)
        got = QV.qmv(codes, v)
        want = QV.qmv_plain(codes, v)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ref_max = float(want.abs().max())
        if not err <= QMV_TOL * ref_max:
            raise AssertionError(f"qmv {tuple(codes.shape)} transposed={transposed}: "
                                 f"max err {err} > {QMV_TOL} x {ref_max}")
        if not torch.equal(QV.qmv(codes, v), got):
            raise AssertionError(f"qmv {tuple(codes.shape)}: not run-to-run identical")
        calls.append((codes, v))
        p = QV.plan(rr, cc, *codes.stride(), codes.data_ptr())
        codes_f32 = codes.to(torch.float32)
        ms = _timed(lambda: QV.qmv(codes, v), flush)
        plain_ms = _timed(lambda: QV.qmv_plain(codes, v), flush)
        lib_ms = _timed(lambda: torch.mv(codes_f32, v), flush)
        nbytes = rr * cc + 4 * cc + 4 * rr
        bound_ms, bound_by = _bound(nbytes, 2 * rr * cc, F32_FLOPS)
        view = "transposed view " if transposed else ""
        rows.append({"name": f"qmv int8 {view}R{rr} C{cc}",
                     "key": (rr, cc, p.layout == "cols"),   # the wrapper's shape key
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"[kernel] qmv {view}(R,C)=({rr},{cc}): {p.layout} width {p.width} unroll "
              f"{p.unroll} splits {p.splits}; max_err={err:.3e} (tol {QMV_TOL:g} x "
              f"{ref_max:.3g}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} (torch.mv on f32 codes) bound_ms={bound_ms:.5f} "
              f"({bound_by}, {nbytes} bytes at 3.35 TB/s)", flush=True)
    for r, (codes, v) in zip(rows, calls):
        n_cuda, names = _cuda_launches(lambda: QV.qmv(codes, v))
        if n_cuda != 1:
            raise AssertionError(f"qmv {tuple(codes.shape)}: {n_cuda} device launches a "
                                 f"call ({names}), not 1")
        r["cuda_launches_per_call"] = n_cuda
    print("[kernel] qmv cuda launches per call (torch.profiler, 5 calls a row): " + ", ".join(
        f"{r['name'][9:]} {r['cuda_launches_per_call']:g}" for r in rows), flush=True)
    return rows


def train_linear_full(dev):
    """Drive slice 2's main path once: LS-SVM on gisette (6000 × 5000) at
    e2e 6/8/8 bits, with the ds_quant, qmv and threefry counters set to 0
    just before and read just after; then the fp32 run and the convergence
    check."""
    import torch
    from repro_torch.core.linear import make_dataset, train_linear
    from repro_torch.kernels import qmv as QV
    from repro_torch.kernels import stoch_quant as SQ
    from repro_torch.kernels import threefry as TF
    from repro_torch.quant import PrecisionPlan

    t0 = time.perf_counter()
    ds = make_dataset("gisette")
    data_s = time.perf_counter() - t0
    steps = LINEAR["epochs"] * (ds.a_train.shape[0] // LINEAR["batch"])
    plans = {"e2e": PrecisionPlan("e2e", sample_bits=6, model_bits=8, grad_bits=8),
             "fp32": PrecisionPlan("full")}
    runs = {}
    for name, plan in plans.items():
        SQ.reset_counts()
        QV.launches = 0
        QV.shape_launches.clear()
        TF.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_linear(ds, plan, device=dev, **LINEAR)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"ds_quant_keyed": SQ.keyed_launches, "qmv": QV.launches,
                    "ds_quant": SQ.launches, "threefry": TF.launches}
        if not np.isfinite(res.losses).all() or res.x.shape != (ds.n_features,):
            raise AssertionError(f"[linear] {name}: losses {res.losses}, x {res.x.shape}")
        runs[name] = {"losses": res.losses.tolist(), "wall_s": wall,
                      "ms_per_step": 1e3 * wall / steps, "steps_per_s": steps / wall,
                      "launches": launches,
                      "ds_shape_launches": [[*k, n] for k, n in SQ.shape_launches.items()],
                      "qmv_shape_launches": [[*k, n] for k, n in QV.shape_launches.items()],
                      "threefry_shape_launches": [[*k, n] for k, n in
                                                  TF.shape_launches.items()]}
        print(f"[linear] gisette {ds.a_train.shape} lssvm {name}: {steps} steps in "
              f"{wall:.3f} s = {runs[name]['ms_per_step']:.3f} ms/step, "
              f"{runs[name]['steps_per_s']:.1f} steps/s; epoch losses {res.losses.tolist()}; "
              f"launches {launches}", flush=True)
    e2e, fp32 = runs["e2e"], runs["fp32"]
    # an e2e step: B1's keyed entry, four qmv, and the two uniform planes of
    # the model's and the gradient's stochastic rounding
    want = {"ds_quant_keyed": steps, "qmv": 4 * steps, "ds_quant": 0, "threefry": 2 * steps}
    if e2e["launches"] != want:
        raise AssertionError(f"[linear] e2e launches {e2e['launches']}, expected {want}")
    if any(fp32["launches"].values()):
        raise AssertionError(f"[linear] fp32 run launched kernels: {fp32['launches']}")
    limit = 1.4 * fp32["losses"][-1] + 1e-4
    if not e2e["losses"][-1] <= limit:
        raise AssertionError(f"[linear] e2e final loss {e2e['losses'][-1]} > 1.4 x fp32 "
                             f"+ 1e-4 = {limit}")
    print(f"[linear] convergence: e2e {e2e['losses'][-1]:.6f} <= 1.4 x fp32 "
          f"{fp32['losses'][-1]:.6f} + 1e-4 = {limit:.6f}", flush=True)
    with _uncounted():
        prof = profile_linear(ds, plans["e2e"], dev)
    return {"dataset": "gisette", "shape": list(ds.a_train.shape), "steps": steps,
            "data_s": data_s, **LINEAR, "runs": runs, "loss_limit": limit,
            "profile": prof}


def profile_linear(ds, plan, dev, steps: int = 20):
    """Where an e2e step's time goes: ``torch.profiler`` over one epoch of
    ``steps`` steps (the first steps·batch rows of the same data; the step's
    work does not depend on the row count) after a warm-up run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.linear import Dataset, train_linear

    rows = steps * LINEAR["batch"]
    small = Dataset(ds.a_train[:rows], ds.b_train[:rows], ds.a_test, ds.b_test, ds.name)
    kw = dict(LINEAR, epochs=1)
    train_linear(small, plan, device=dev, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_linear(small, plan, device=dev, **kw)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel, n_events = _device_kernels(prof)
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_events_per_step": n_events / steps,
           "device_ms_per_step": device_ms / steps if device_ms else None,
           "device_busy_share": device_ms / wall_ms if device_ms else None,
           "ported_kernels_ms_per_step": {
               k: sum(v for n, v in by_kernel.items() if k in n) / steps
               for k in ("ds_quant_kernel", "qmv_rows", "qmv_cols", "threefry_plane")},
           "top_kernels_ms_per_step": {k: v / steps for k, v in top}}
    if device_ms:
        print(f"[linear-profile] {steps} e2e steps: wall {out['wall_ms_per_step']:.3f} ms/step "
              f"(profiled), {out['device_events_per_step']:.0f} device events/step, device busy "
              f"{out['device_ms_per_step']:.4f} ms/step, busy share "
              f"{out['device_busy_share']:.4f}; ported kernels ms/step "
              f"{out['ported_kernels_ms_per_step']}; top: " + "; ".join(
                  f"{k[:40]} {v:.4f}" for k, v in out["top_kernels_ms_per_step"].items()),
              flush=True)
    else:
        print("[linear-profile] torch.profiler recorded no device time: not measured",
              flush=True)
    return out


def agree_linear(dev):
    """synthetic100 (n_train 256, 2 epochs, e2e 6/8/8) on the card against
    the same call on the CPU's plain path: the sample codes of every step
    must be identical, the per-epoch losses equal within rel 1e-5."""
    import torch
    from repro_torch.core.linear import make_dataset, train_linear
    from repro_torch.kernels import stoch_quant as SQ
    from repro_torch.quant import PrecisionPlan

    ds = make_dataset("synthetic100", n_train=256, n_test=64)
    plan = PrecisionPlan("e2e", sample_bits=6, model_bits=8, grad_bits=8, backend="cuda")
    inner = SQ.ds_quant_keyed      # what ops.ds_quantize calls
    out = {}
    for where in (dev, "cpu"):
        codes = []

        def record(*a, **k):
            c1, c2 = inner(*a, **k)
            codes.append((c1.cpu(), c2.cpu()))
            return c1, c2

        SQ.ds_quant_keyed = record
        try:
            res = train_linear(ds, plan, model="lssvm", epochs=2, lr=0.3, device=where)
        finally:
            SQ.ds_quant_keyed = inner
        out[str(where)] = (res, codes)
    (card, card_codes), (cpu, cpu_codes) = out[str(dev)], out["cpu"]
    steps = 2 * (256 // 16)
    if len(card_codes) != steps or len(cpu_codes) != steps:
        raise AssertionError(f"[check] {len(card_codes)}/{len(cpu_codes)} ds_quant calls, "
                             f"expected {steps}")
    same = sum(int(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
               for a, b in zip(card_codes, cpu_codes))
    if same != steps:
        raise AssertionError(f"[check] sample codes identical on {same} of {steps} steps")
    rel = np.abs(card.losses - cpu.losses) / np.abs(cpu.losses)
    if not (rel <= LINEAR_LOSS_TOL).all():
        raise AssertionError(f"[check] losses card {card.losses} vs CPU {cpu.losses}")
    print(f"[check] synthetic100 lssvm e2e 6/8/8: sample codes identical on {same}/{steps} "
          f"steps (card kernels vs CPU plain path); epoch losses card {card.losses.tolist()} "
          f"CPU {cpu.losses.tolist()} (max rel diff {rel.max():.2e}, tol {LINEAR_LOSS_TOL:g})",
          flush=True)
    return {"steps_codes_identical": same, "steps": steps, "losses_card": card.losses.tolist(),
            "losses_cpu": cpu.losses.tolist(), "max_rel_loss_diff": float(rel.max())}


def _qmm_t_checked(g, qt, packed, what):
    """``qmm_t`` on the card against its plain version (rel ``QMM_TOL`` of
    the largest output), one launch on the core ``qmm_t.plan`` gives its
    shape; returns (core, max abs err, largest |plain|)."""
    import torch
    from repro_torch.kernels import qmm_t as QT

    m, n = g.shape
    core = QT.plan(m, qt.codes.shape[0], n).core
    before = {"stream": QT.stream_launches, "tc": QT.tc_launches}
    got = QT.qmm_t(g, qt.codes, qt.scale, packed=packed)
    ran = {"stream": QT.stream_launches - before["stream"], "tc": QT.tc_launches - before["tc"]}
    if ran != {c: int(c == core) for c in ran}:
        raise AssertionError(f"{what}: planned core {core}, ran {ran}")
    want = QT.qmm_t_plain(g, qt.codes, qt.scale, packed=packed)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ref_max = float(want.abs().max())
    if not err <= QMM_TOL * ref_max:
        raise AssertionError(f"{what} ({core}): max err {err} > {QMM_TOL} x {ref_max}")
    return core, err, ref_max


def _qmm_t_core_gate(what: str, core: str) -> dict:
    """Fail unless every ``qmm_t`` launch since its counters were reset ran
    on ``core``, the core that ``qmm_t.plan`` gives each launched shape;
    returns the per-core counts."""
    from repro_torch.kernels import qmm_t as QT

    got = {"stream": QT.stream_launches, "tc": QT.tc_launches}
    planned = {QT.plan(m, k, n).core for (packed, m, k, n) in QT.shape_launches}
    if got != {c: QT.launches * (c == core) for c in got} or planned - {core}:
        raise AssertionError(f"{what}: qmm_t launches by core {got} (plan gives "
                             f"{sorted(planned)}), expected all on {core}")
    return got


def check_qmm_t(dev, flush):
    """``qmm_t`` against its plain version (rel 1e-5 of the largest output)
    at the training path's shapes, int8 and packed int4, f32 g (the
    cotangent the backward hands it), on the tensor-core core;
    ``torch.matmul`` of g (bf16) with the bf16-decoded weight transposed is
    the library yardstick."""
    import torch
    from repro_torch.kernels import qmm_t as QT
    from repro_torch.quant import QScheme, encode

    rows = []
    gen = torch.Generator(device=dev).manual_seed(5)
    for bits in (8, 4):
        packed = bits == 4
        for m, k, n in QMM_T_SHAPES:
            w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
            qt = encode(w, QScheme.int_symmetric(bits, scaling="channel",
                                                 rounding="nearest", packed=packed))
            g = torch.randn(m, n, generator=gen, device=dev)
            core, err, ref_max = _qmm_t_checked(g, qt, packed, f"qmm_t int{bits} {m}x{k}x{n}")
            if core != "tc":
                raise AssertionError(f"qmm_t int{bits} {m}x{k}x{n}: planned on {core}")
            w_bf16 = qt.decode().to(torch.bfloat16)
            g_bf16 = g.to(torch.bfloat16)
            ms = _timed(lambda: QT.qmm_t(g, qt.codes, qt.scale, packed=packed), flush)
            plain_ms = _timed(lambda: QT.qmm_t_plain(g, qt.codes, qt.scale, packed=packed),
                              flush)
            lib_ms = _timed(lambda: torch.matmul(g_bf16, w_bf16.T), flush)
            nbytes = g.numel() * 4 + qt.codes.numel() + n * 4 + m * k * 4
            # the least time for this work whatever computes it: one bf16
            # tensor-core product of the same shape (the bf16 matmul beside
            # it computes a rounded version of it). The kernel runs three
            # such products (g · scale in three bf16 pieces): its own floor
            # is three times the operations at the bf16 rate
            bound_ms, bound_by = _bound(nbytes, 2 * m * k * n)
            floor_ms = 3 * 2 * m * k * n / BF16_FLOPS * 1e3
            rows.append({"name": f"qmm_t int{bits} M{m} K{k} N{n}", "key": (packed, m, k, n),
                         "core": core, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "three_pass_floor_ms": floor_ms})
            print(f"[kernel] qmm_t int{bits} (M,K,N)=({m},{k},{n}): core={core} "
                  f"max_err={err:.3e} (tol {QMM_TOL:g} x {ref_max:.3g}) kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (bf16 matmul) "
                  f"bound_ms={bound_ms:.4f} ({bound_by}) three_pass_floor_ms={floor_ms:.4f}",
                  flush=True)
            del w, qt, g, w_bf16, g_bf16
    return rows


def check_quant_adamw(dev, flush):
    """Both passes of ``quant_adamw`` against ``quant_adamw_ref`` (the
    reference's contract: masters rtol 2e-6 / atol 2e-6, scales rtol 1e-6,
    ≥ 99.9 % of codes equal) at every leaf shape of the training path;
    pass 1's path entry (``qadamw_scales``) bit-equal to its plain version
    and to the scales of the max of the parity entry's partials, and both
    entries NaN in a column whose g holds a NaN (at ``ADAMW_NAN_SHAPE``); pass 2's
    keyed entry bit-equal (masters and codes) to its rand entry on the
    key's ``prng.bits`` plane. Each entry timed against its plain version
    and its bound (pass 1 reads 6 bytes per element, pass 2 moves 20, keyed
    16 and the hash's int32 operations; its plain version draws the plane by
    the int64 path; no PyTorch call computes the same function); the path
    entry also beside the parity entry with the host's reduction after it
    (the design before the path entry) and pass 1's time before its
    redesign."""
    import torch
    from repro_torch import prng
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import quant_adamw as QA
    from repro_torch.kernels import threefry as TF

    rows, gen = [], torch.Generator(device=dev).manual_seed(6)
    for r, c in ADAMW_SHAPES:
        master = torch.randn(r, c, generator=gen, device=dev)
        g = torch.randn(r, c, generator=gen, device=dev) * 0.1
        mc = torch.randint(-127, 128, (r, c), generator=gen, device=dev, dtype=torch.int8)
        vc = torch.randint(0, 128, (r, c), generator=gen, device=dev, dtype=torch.int8)
        ms = torch.rand(c, generator=gen, device=dev) * 0.01 + 1e-4
        vs = torch.rand(c, generator=gen, device=dev) * 0.01 + 1e-4
        rand = torch.randint(-2 ** 31, 2 ** 31, (r, c), generator=gen, device=dev,
                             dtype=torch.int32)
        args = (master, g, mc, ms, vc, vs, rand)
        nm, mcn, msn, vcn, vsn = ops.quant_adamw_update(*args, **ADAMW_KW)
        want = ref.quant_adamw_ref(*args, **ADAMW_KW)
        torch.cuda.synchronize()
        err = float((nm - want[0]).abs().max())
        torch.testing.assert_close(nm, want[0], rtol=2e-6, atol=2e-6)
        torch.testing.assert_close(msn, want[2], rtol=1e-6, atol=0)
        torch.testing.assert_close(vsn, want[4], rtol=1e-6, atol=0)
        same = min(float((mcn == want[1]).float().mean()), float((vcn == want[3]).float().mean()))
        if same < 0.999:
            raise AssertionError(f"quant_adamw ({r},{c}): {same:.5f} of codes equal < 0.999")
        del want, nm, mcn, vcn
        kw = {k: ADAMW_KW[k] for k in ("b1", "b2")}
        params = torch.tensor([ADAMW_KW["clip"], ADAMW_KW["finite"], ADAMW_KW["lr"],
                               ADAMW_KW["b1c"], ADAMW_KW["b2c"], 0, 0, 0],
                              dtype=torch.float32, device=dev)
        p1 = (g, mc, ms, vc, vs, params)
        qm = ADAMW_KW["qmax"]

        def parity_then_host():
            mx, vx = QA.qadamw_absmax(*p1, **kw)
            return (ref.adamw_scale_ref(torch.amax(mx, dim=0), qm),
                    ref.adamw_scale_ref(torch.amax(vx, dim=0), qm))

        for gg in ((g,) if (r, c) != ADAMW_NAN_SHAPE else (g, g.clone())):
            if gg is not g:                       # the NaN row: column c // 3
                gg[r // 2, c // 3] = float("nan")
            q1 = (gg, *p1[1:])
            scales = QA.qadamw_scales(*q1, **kw, qmax=qm)
            plain = QA.qadamw_scales_plain(*q1, **kw, qmax=qm)
            mx, vx = QA.qadamw_absmax(*q1, **kw)
            torch.cuda.synchronize()
            of_partials = (ref.adamw_scale_ref(torch.amax(mx, dim=0), qm),
                           ref.adamw_scale_ref(torch.amax(vx, dim=0), qm))
            nan_cols = {c // 3} if gg is not g else set()
            for a, b, t in zip(scales, plain, of_partials):
                nan = torch.isnan(b)
                if set(torch.nonzero(nan).flatten().tolist()) != nan_cols or \
                        not torch.equal(torch.isnan(a), nan) or \
                        not torch.equal(torch.isnan(t), nan) or \
                        not torch.equal(a[~nan], b[~nan]) or not torch.equal(t[~nan], b[~nan]):
                    raise AssertionError(
                        f"qadamw_scales ({r},{c}){' NaN g' if nan_cols else ''}: not "
                        "bit-equal to its plain version and the max of the parity entry's "
                        f"partials, or NaN columns {set(torch.nonzero(torch.isnan(a)).flatten().tolist())} "
                        f"against {nan_cols}")
            if nan_cols:
                print(f"[kernel] quant_adamw qadamw_scales (R,C)=({r},{c}) NaN g at "
                      f"({r // 2},{c // 3}): both entries and the plain version NaN in that "
                      "column alone", flush=True)
            del scales, plain, mx, vx, of_partials
        if not all(torch.equal(x, y) for x, y in zip((msn, vsn), QA.qadamw_scales(
                *p1, **kw, qmax=qm))):
            raise AssertionError(f"quant_adamw ({r},{c}): the update's scales are not "
                                 "qadamw_scales'")
        ukw = dict(kw, eps=ADAMW_KW["eps"], wd=ADAMW_KW["wd"], qmax=127,
                   uclip=ADAMW_KW["uclip"])
        upd_args = (master, g, mc, ms, vc, vs, msn, vsn)
        key = prng.PRNGKey(r + c)
        keyed = QA.qadamw_update(*upd_args, None, params, key=key, **ukw)
        on_plane = QA.qadamw_update(*upd_args, prng.bits(key, (r, c), device=dev,
                                                         dtype=torch.int32), params, **ukw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(keyed, on_plane)):
            raise AssertionError(f"quant_adamw ({r},{c}): the keyed entry is not bit-equal "
                                 "to the rand entry on the key's plane")
        del keyed, on_plane
        p1_bytes = 6 * r * c + 8 * c
        for name, fn, plain, nbytes, ops_per_elem, more in (
                ("qadamw_scales", lambda: QA.qadamw_scales(*p1, **kw, qmax=qm),
                 lambda: QA.qadamw_scales_plain(*p1, **kw, qmax=qm), p1_bytes + 8 * c, 15, []),
                ("qadamw_absmax", lambda: QA.qadamw_absmax(*p1, **kw),
                 lambda: QA.qadamw_absmax_plain(*p1, **kw),
                 p1_bytes + 8 * -(-r // QA.ROWS_PER_BLOCK) * c, 15, []),
                ("qadamw_update",
                 lambda: QA.qadamw_update(*upd_args, rand, params, **ukw),
                 lambda: QA.qadamw_update_plain(*upd_args, rand, params, **ukw),
                 20 * r * c + 16 * c, 40, []),
                ("qadamw_update_keyed",
                 lambda: QA.qadamw_update(*upd_args, None, params, key=key, **ukw),
                 lambda: QA.qadamw_update_plain(
                     *upd_args, TF.threefry_plane_plain(key, (r, c), out="int32", device=dev), params, **ukw),
                 16 * r * c + 16 * c, 40, [(HASH_ALU_OPS * r * c, INT32_OPS)])):
            k_ms = _timed(fn, flush, iters=10)
            plain_ms = _timed(plain, flush, iters=3)
            bound_ms, bound_by = _bound(nbytes, ops_per_elem * r * c, F32_FLOPS, *more)
            label = {"qadamw_scales": "pass 1", "qadamw_absmax": "pass 1 partials",
                     "qadamw_update": "pass 2", "qadamw_update_keyed": "pass 2 keyed"}[name]
            row = {"name": f"quant_adamw {label} ({name}) R{r} C{c}", "key": (name, r, c),
                   "max_abs_err": 0.0 if name == "qadamw_scales" else err, "ms": k_ms,
                   "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
                   "bound_by": bound_by}
            extra = ""
            if name == "qadamw_scales":
                p = QA.plan(r, c, QA._alignment(g, mc, vc))
                row["parity_then_host_ms"] = _timed(parity_then_host, flush, iters=10)
                row["before_ms"] = ADAMW_PASS1_BEFORE_MS.get((r, c))
                extra = (f" bound/ms={bound_ms / k_ms:.3f}; parity entry + host reduction "
                         f"{row['parity_then_host_ms']:.4f} ms; before its redesign "
                         f"{row['before_ms']} ms; plan width {p.width} rows {p.rows} "
                         f"tiles {p.tiles} runs {p.runs} ({p.tiles * p.runs} blocks)")
            rows.append(row)
            print(f"[kernel] quant_adamw {name} (R,C)=({r},{c}): "
                  + ("scales bit-equal to the plain version and the partials' max"
                     if name == "qadamw_scales" else
                     f"masters max_err={err:.3e} (rtol 2e-6), codes equal >= {same:.5f}")
                  + f" kernel_ms={k_ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
                  f"({bound_by}, {nbytes} bytes at 3.35 TB/s"
                  f"{f', {HASH_ALU_OPS} int32 shifts and xors an element' if more else ''})"
                  + extra, flush=True)
        del args, upd_args, master, g, mc, vc, rand, msn, vsn, p1
        torch.cuda.empty_cache()
    return rows


def _train_counters(reset: bool = False):
    from repro_torch.kernels import qmm as Q
    from repro_torch.kernels import qmm_t as QT
    from repro_torch.kernels import quant_adamw as QA

    from repro_torch.kernels import threefry as TF

    if reset:
        Q.reset_counters()
        QT.reset_counters()
        QA.absmax_launches = QA.scales_launches = 0
        QA.update_launches = QA.keyed_update_launches = 0
        QA.shape_launches.clear()
        TF.reset_counts()
    return {"qmm": Q.launches, "qmm_t": QT.launches, "qadamw_scales": QA.scales_launches,
            "qadamw_update_keyed": QA.keyed_update_launches, "threefry": TF.launches,
            "qadamw_absmax": QA.absmax_launches, "qadamw_update": QA.update_launches}


def train_full(dev, checked):
    """Drive slice 3's main path once: full-width gemma-2b through
    ``repro_torch.launch.train.make_trainer`` + ``Trainer.run``, ship-quantized
    int8 weights, int8 gradients with error feedback, int8 AdamW moments,
    with the kernels' counters set to 0 just before and read just after
    (``qmm``, ``qmm_t``, pass 1, pass 2's keyed entry — its rand entry must
    stay at 0 — and the threefry planes of the model and gradient channels);
    then the bf16 yardstick (no channel, f32 moments), which must launch
    none of them."""
    import torch
    from repro_torch.kernels import qmm as Q
    from repro_torch.kernels import qmm_t as QT
    from repro_torch.kernels import quant_adamw as QA
    from repro_torch.kernels import threefry as TF
    from repro_torch.launch.train import make_trainer
    from repro_torch.quant import PrecisionPlan

    b, s, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    runs = {}
    for name, plan, mbits, n in (
            ("all8", PrecisionPlan(model_bits=8, model_storage="ship", grad_bits=8), 8, steps),
            ("bf16", PrecisionPlan(), 0, 3)):
        tr = make_trainer("gemma-2b", reduced=False, batch=b, seq=s, steps=n,
                          lr=TRAIN["lr"], moment_bits=mbits, precision=plan, device=dev,
                          log_every=1)
        cfg = tr.cfg
        if cfg.n_layers != 18 or cfg.d_model != 2048 or cfg.vocab_size != 256000:
            raise AssertionError(f"not full-width gemma-2b: {cfg}")
        t0 = time.perf_counter()
        state = tr.init_state()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        _train_counters(reset=True)
        state, losses = tr.run(n, state=state)
        torch.cuda.synchronize()
        launches = _train_counters()
        qmm_cores = _core_gate(f"[train] {name}", Q, checked)
        qmm_t_cores = _qmm_t_core_gate(f"[train] {name}", "tc")
        shapes = {name: [[*key, c] for key, c in counter.items()] for name, counter in
                  (("qmm", Q.shape_launches), ("qmm_t", QT.shape_launches),
                   ("quant_adamw", QA.shape_launches), ("threefry", TF.shape_launches))}
        hist = tr.history
        step_ms = [1e3 * h["seconds"] for h in hist]
        ms = statistics.median(step_ms[1:])
        run = {"losses": losses, "step_ms": step_ms, "ms_per_step": ms,
               "tokens_per_s": b * s / (ms / 1e3), "init_s": init_s,
               "skipped": [h["skipped"] for h in hist],
               "grad_norm": [h["grad_norm"] for h in hist],
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "launches": launches, "qmm_launches_by_core": qmm_cores,
               "qmm_t_launches_by_core": qmm_t_cores,
               "launches_per_step": {k: v / n for k, v in launches.items()},
               "shape_launches": shapes}
        print(f"[train] gemma-2b full width {name} (B={b}, S={s}, {n} steps): losses "
              f"{[round(x, 4) for x in losses]}; {ms:.1f} ms/step (median of steps 2-{n}), "
              f"{run['tokens_per_s']:.1f} tokens/s; max_memory_allocated "
              f"{run['max_memory_allocated'] / 2 ** 30:.2f} GiB; launches per step "
              f"{run['launches_per_step']}, qmm by core {qmm_cores}, qmm_t by core "
              f"{qmm_t_cores}; skipped "
              f"{run['skipped']}", flush=True)
        if not (np.isfinite(losses).all() and all(x == 0 for x in run["skipped"])):
            raise AssertionError(f"[train] {name}: losses {losses}, skipped {run['skipped']}")
        runs[name] = run
        if name == "all8":
            prof = profile_train(tr, state)
        del tr, state
        torch.cuda.empty_cache()
    all8, bf16 = runs["all8"], runs["bf16"]
    parity = ("qadamw_update", "qadamw_absmax")     # the parity entries: never on the path
    zero = [k for k, v in all8["launches"].items() if v <= 0 and k not in parity]
    if zero:
        raise AssertionError(f"[train] kernels {zero} were not launched on the main path")
    if all8["launches"]["qadamw_update"]:
        raise AssertionError(f"[train] pass 2 took the rand entry (a moments plane) "
                             f"{all8['launches']['qadamw_update']} times, not the keyed one")
    if all8["launches"]["qadamw_absmax"]:
        raise AssertionError(f"[train] pass 1 took the parity entry (partials reduced on the "
                             f"host) {all8['launches']['qadamw_absmax']} times, not "
                             "qadamw_scales")
    if all8["launches"]["qadamw_scales"] != all8["launches"]["qadamw_update_keyed"]:
        raise AssertionError(f"[train] pass 1 launched {all8['launches']['qadamw_scales']} "
                             f"times, pass 2 {all8['launches']['qadamw_update_keyed']}: one "
                             "each a 2-D leaf")
    if any(bf16["launches"].values()):
        raise AssertionError(f"[train] the bf16 yardstick launched {bf16['launches']}")
    if not all8["losses"][-1] < all8["losses"][0]:
        raise AssertionError(f"[train] loss did not fall: {all8['losses']}")
    return {**TRAIN, "runs": runs, "profile": prof}


def profile_train(tr, state, steps: int = 2):
    """Where a training step's time goes: ``torch.profiler`` over ``steps``
    steps — device time by kernel, the device's busy share of the window,
    and the shares of the ported kernels, of the threefry plane kernel and
    of the int64 kernels (the int64 threefry path's elementwise ops, before
    the plane kernel; the group must read 0, and the names of any kernel
    it holds are printed)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import qmm_t as QT

    n0 = state.step
    torch.cuda.synchronize()
    before = _train_counters()
    shapes_before = dict(QT.shape_launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = tr.run(n0 + steps, state=state)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # kernel names: qmm_t's all begin "qmm_t_" (qmm_t_split, qmm_t_tc,
    # qmm_t_stream), which no name of qmm's contains; a split contraction
    # would add qmm_core.cuh's splitk_reduce, which qmm launches too, so
    # the window must hold none (checked below)
    # the plane kernel's signature holds "long long" too: its group goes
    # before the int64 one (the first group that matches takes a kernel)
    groups = {"qmm": ("qmm_simt", "qmm_tc", "splitk_reduce"), "qmm_t": ("qmm_t_",),
              "quant_adamw": ("absmax_kernel", "update_kernel"),
              "threefry (plane kernel)": ("threefry_plane",),
              "threefry (int64 elementwise)": ("long",)}
    by_group = {k: 0.0 for k in groups}
    group_kernels = {k: collections.Counter() for k in groups}   # ms per step by name
    device_ms, n_events = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        n_events += ev.count
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        device_ms += us / 1e3
        for gname, keys in groups.items():
            if any(k in ev.key for k in keys):
                by_group[gname] += us / 1e3
                group_kernels[gname][ev.key[:90]] += us / 1e3 / steps
                break
    after = _train_counters()
    split = sorted(key for key, n in QT.shape_launches.items()
                   if n > shapes_before.get(key, 0) and QT.plan(*key[1:]).splits > 1)
    if split:
        raise AssertionError(f"[train-profile] qmm_t split the contraction at (packed, M, K, "
                             f"N) {split}: its splitk_reduce would count in qmm's group")
    launched = {"qmm": after["qmm"] - before["qmm"], "qmm_t": after["qmm_t"] - before["qmm_t"],
                "quant_adamw": sum(after[k] - before[k] for k in
                                   ("qadamw_scales", "qadamw_absmax", "qadamw_update",
                                    "qadamw_update_keyed")),
                "threefry (plane kernel)": after["threefry"] - before["threefry"]}
    between = _ops_between_passes(prof)
    pass1_ms = sum(ms for k, ms in group_kernels["quant_adamw"].items() if "absmax_kernel" in k)
    leaves = after["qadamw_scales"] - before["qadamw_scales"]
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps, "launches": launched,
           "quant_adamw_pass1_ms_per_step": pass1_ms,
           "device_ops_between_passes": {"leaves": len(between), "max": max(between, default=0),
                                         "total": sum(between)},
           "device_events_per_step": n_events / steps,
           "device_ms_per_step": device_ms / steps if device_ms else None,
           "device_busy_share": device_ms / wall_ms if device_ms else None,
           "share_of_device_time": {k: v / device_ms for k, v in by_group.items()}
           if device_ms else None,
           "ms_per_step_by_group": {k: v / steps for k, v in by_group.items()},
           "kernels_ms_per_step_by_group": {k: dict(v.most_common())
                                            for k, v in group_kernels.items()}}
    if device_ms:
        print(f"[train-profile] {steps} steps: wall {out['wall_ms_per_step']:.1f} ms/step "
              f"(profiled), {out['device_events_per_step']:.0f} device events/step, device "
              f"busy {out['device_ms_per_step']:.1f} ms/step, busy share "
              f"{out['device_busy_share']:.3f}; share of device time " + ", ".join(
                  f"{k} {v:.3f}" for k, v in out["share_of_device_time"].items()), flush=True)
        print(f"[train-profile] quant_adamw pass 1 (qadamw_scales) {pass1_ms:.3f} ms/step; "
              f"device ops between pass 1 and pass 2 of a leaf: {sum(between)} over "
              f"{len(between)} leaves (max {max(between, default=0)})", flush=True)
        if len(between) != leaves or any(between):
            raise AssertionError(f"[train-profile] {leaves} pass-1 launches, device ops "
                                 f"between pass 1 and pass 2 of each leaf {between}: must "
                                 "all be 0")
        print(f"[train-profile] ms per step by group {out['ms_per_step_by_group']}; int64 "
              f"kernels (none is threefry's unless TF.int64_cuda_planes > 0, which fails the "
              f"phase): {dict(group_kernels['threefry (int64 elementwise)']) or 'none'}",
              flush=True)
        # a group whose kernels launched in the window but read no device
        # time has lost its kernel names (a renamed kernel): its share
        # would silently read 0
        unread = [k for k, n in launched.items() if n and not by_group[k]]
        if unread:
            raise AssertionError(f"[train-profile] groups {unread} launched {launched} but "
                                 f"read 0 device ms: their kernel names are not in {groups}")
    else:
        print("[train-profile] torch.profiler recorded no device time: not measured", flush=True)
    return out


def _ops_between_passes(prof) -> list[int]:
    """For each pass-1 launch in ``prof`` (a kernel named absmax_kernel),
    the device events (kernels, memsets, copies) that start after it and
    before the next pass-2 launch (update_kernel), in device time order."""
    from torch.autograd import DeviceType

    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    counts, open_ = [], None
    for e in evs:
        if "absmax_kernel" in e.name:
            if open_ is not None:
                counts.append(open_)
            open_ = 0
        elif "update_kernel" in e.name:
            if open_ is not None:
                counts.append(open_)
            open_ = None
        elif open_ is not None:
            open_ += 1
    if open_ is not None:
        counts.append(open_)
    return counts


def _update_diff(got, before, after):
    """The masters' update of ``got`` (got − before) against the reference
    state's (after − before): per leaf, the entries off by more than
    TRAIN_CHECK_TOL of the leaf's largest update and the leaf's size; and
    the relative L2 distance of the two updates over the model."""
    from repro_torch.tree import tree_leaves

    off, num, den = [], 0.0, 0.0
    for a, b, z in zip(*(tree_leaves(st.opt.master) for st in (got, after, before))):
        du_t, du_c = (a.double() - z.double()), (b.double() - z.double())
        if not float(du_c.abs().max()) > 0:
            raise AssertionError("[check] the CPU plain path left a master unchanged")
        off.append((int(((du_t - du_c).abs() > TRAIN_CHECK_TOL * du_c.abs().max()).sum()),
                    du_c.numel()))
        num, den = num + float(((du_t - du_c) ** 2).sum()), den + float((du_c ** 2).sum())
    return off, (num / den) ** 0.5


def agree_train(dev):
    """The reduced gemma-2b at f32, all three channels at 8 bits (every
    weight shipped), lr 1e-3 from the first step, 3 steps on the card
    (kernels) and on the CPU's plain path from one initial state. A free run
    on the card: losses rel 1e-4, the masters' update within a relative L2
    distance of FREE_RUN_UPDATE_L2. Each step on the card from the CPU's
    state: ≥ 99.9 % of the masters' update entries within 1e-4 of their
    leaf's largest update (no leaf with more than 2 + 0.1 % of its entries
    off), ≥ 99.9 % of the moment codes and of the gradient codes (read from
    the error-feedback residual) equal."""
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenStreamConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.quant import PrecisionPlan
    from repro_torch.train import Trainer, default_channels
    from repro_torch.train.channels import ModelChannel
    from repro_torch.tree import tree_leaves

    plan = PrecisionPlan(model_bits=8, model_storage="ship", grad_bits=8, backend="cuda")
    cfg = configs.get_reduced("gemma-2b", dtype=torch.float32, precision=plan)
    trainers = {}
    for where in ("cpu", dev):
        chans = dict(default_channels(plan), model=ModelChannel(plan, ship_min_size=0))
        trainers[str(where)] = Trainer(
            cfg, AdamWConfig(moment_bits=8, **TRAIN_CHECK_OPT), channels=chans,
            device=where, stream_cfg=TokenStreamConfig(cfg.vocab_size, 16, 2))
    cpu_tr, card_tr = trainers["cpu"], trainers[str(dev)]
    batches = [cpu_tr.stream.next_batch() for _ in range(3)]
    cpu_states, cpu_l = [cpu_tr.init_state()], []
    before = _train_counters()
    for b in batches:                       # a step consumes its state: keep copies
        st, m = cpu_tr.step(cpu_states[-1].to("cpu"), b)
        cpu_states.append(st)
        cpu_l.append(float(m["loss"]))
    cpu_n = {k: v - before[k] for k, v in _train_counters().items()}

    before = _train_counters()
    card, card_l = cpu_states[0].to(dev), []
    for b in batches:
        card, m = card_tr.step(card, b)
        card_l.append(float(m["loss"]))
    free_l2 = _update_diff(card.to("cpu"), cpu_states[0], cpu_states[-1])[1]

    def equal_share(pairs):
        pairs = list(pairs)
        return sum(int(e.sum()) for e in pairs) / sum(e.numel() for e in pairs)

    per_step, step_ok = [], True
    for i, b in enumerate(batches):
        got, _ = card_tr.step(cpu_states[i].to(dev), b)
        got, want = got.to("cpu"), cpu_states[i + 1]
        off, _ = _update_diff(got, cpu_states[i], want)
        codes = {k: equal_share(a.codes == c.codes for a, c in zip(
            tree_leaves(getattr(got.opt, k)), tree_leaves(getattr(want.opt, k))))
            for k in "mv"}
        codes["grad (error feedback)"] = equal_share(
            (a - c).abs() <= 0.25 * c.abs().max() for a, c in zip(
                tree_leaves(got.channels["grad"]["ef"]),
                tree_leaves(want.channels["grad"]["ef"])))
        n_off, n_all = sum(o for o, _ in off), sum(n for _, n in off)
        step_ok &= (n_off <= 1e-3 * n_all and all(o <= 2 + n // 1000 for o, n in off)
                    and min(codes.values()) >= 0.999)
        per_step.append({"master_update_entries_off": n_off, "entries": n_all,
                         "worst_leaf_off": max(o for o, _ in off), "codes_equal": codes})
    card_n = {k: v - before[k] for k, v in _train_counters().items()}
    # pass 1 takes its path entry and pass 2 its keyed entry on the card:
    # the parity entries stay at 0
    parity = ("qadamw_update", "qadamw_absmax")
    if (not all(v for k, v in card_n.items() if k not in parity)
            or any(card_n[k] for k in parity) or any(cpu_n.values())):
        raise AssertionError(f"[check] launches card {card_n}, CPU {cpu_n}")
    rel = np.abs(np.array(card_l) - cpu_l) / np.abs(cpu_l)
    print(f"[check] reduced gemma-2b f32 ship8/grad8/moment8, lr 1e-3, 3 steps: free run "
          f"losses card {card_l} CPU {cpu_l} (max rel {rel.max():.2e}, tol "
          f"{TRAIN_CHECK_TOL:g}), masters' update rel L2 {free_l2:.2e} (tol "
          f"{FREE_RUN_UPDATE_L2:g}); per step from the CPU's state {per_step}; "
          f"card launches {card_n}", flush=True)
    if not (rel <= TRAIN_CHECK_TOL).all() or free_l2 > FREE_RUN_UPDATE_L2 or not step_ok:
        raise AssertionError("[check] training: card and CPU plain path disagree")
    return {"losses_card": card_l, "losses_cpu": cpu_l, "max_rel_loss_diff": float(rel.max()),
            "free_run_master_update_rel_l2": free_l2, "per_step": per_step}


def _prompt_buckets(arch: str = "gemma-2b") -> collections.Counter:
    """Prefill M of the trace served to ``arch`` (its prompt tokens are
    drawn over its vocab): its prompts' lengths rounded up to whole pages
    (``ServeEngine._bucket``), with how many prompts each."""
    from repro_torch import configs
    from repro_torch.launch.serve import make_trace

    page = SERVE["page_size"]
    trace = make_trace(SERVE["n_requests"], configs.get_config(arch).vocab_size,
                       max_new=SERVE["max_new"], max_prompt=SERVE["max_prompt"], seed=0)
    return collections.Counter(-(-len(r.prompt) // page) * page for r in trace)


def _qbp_ms() -> dict:
    """The M at which ``[serve-bitplane]`` and ``[spec]`` launch
    ``qmm_bitplane`` (decode, the verify window, each prompt bucket of the
    served trace) and 128, the largest bucket there can be, with their
    roles."""
    buckets = _prompt_buckets()
    verify_m = SERVE["max_slots"] * (SPEC["spec_decode"] + 1)
    roles = {SERVE["max_slots"]: "decode", verify_m: "verify window"}
    for m in sorted(buckets):
        roles[m] = (roles[m] + " and " if m in roles else "") + f"prefill, bucket {m}"
    if SERVE["max_prompt"] not in buckets:
        roles[SERVE["max_prompt"]] = (f"prefill, bucket {SERVE['max_prompt']}: the largest, "
                                      "no such prompt in the trace")
    return roles


def check_qmm_bitplane(dev, flush):
    """``qmm_bitplane`` against its plain version (rel 1e-5 of the largest
    output) at every M of the serving path (:func:`_qbp_ms`) × gemma-2b's
    (K, N) with 9 and 5 planes, bf16 x; each row checks, through the
    per-core counters, that it ran on the core ``plan`` gives; timed beside
    the plain version, the bf16 ``torch.matmul`` on the decoded weight and
    the bound (the code words, x, y and the scales over HBM bandwidth, or
    2·M·K·N at the bf16 rate: the codes are exact in bf16 and the scale
    comes after the contraction)."""
    import torch
    from repro_torch.kernels import qmm_bitplane as QBP
    from repro_torch.quant import QScheme, encode

    roles, buckets = _qbp_ms(), _prompt_buckets()
    verify_m = SERVE["max_slots"] * (SPEC["spec_decode"] + 1)
    shapes = [(m, k, n) for m in roles for k, n in QBP_KN]
    rows, weights = [], {}
    gen = torch.Generator(device=dev).manual_seed(7)
    for p in QBP_PLANES:
        for m, k, n in [*shapes, QBP_RAGGED]:
            if (k, n) not in weights:
                w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
                weights[(k, n)] = encode(w, QScheme.bitplane(8))
                del w
            qt = weights[(k, n)].slice_planes(p - 1)
            planes = qt.codes.contiguous()
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            core = QBP.plan(k, n, x.dtype).core
            before = {"simt": QBP.simt_launches, "tc": QBP.tc_launches}
            got = QBP.qmm_bitplane(x, planes, qt.scale)
            ran = {c: getattr(QBP, f"{c}_launches") - before[c] for c in before}
            if ran != {c: int(c == core) for c in ran}:
                raise AssertionError(f"qmm_bitplane P{p} {m}x{k}x{n}: planned core {core}, "
                                     f"ran {ran}")
            want = QBP.qmm_bitplane_plain(x, planes, qt.scale)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ref_max = float(want.abs().max())
            if not err <= QMM_TOL * ref_max:
                raise AssertionError(f"qmm_bitplane P{p} {m}x{k}x{n}: max err {err} "
                                     f"> {QMM_TOL} x {ref_max}")
            w_bf16 = qt.decode(torch.bfloat16)
            ms = _timed(lambda: QBP.qmm_bitplane(x, planes, qt.scale), flush)
            plain_ms = _timed(lambda: QBP.qmm_bitplane_plain(x, planes, qt.scale), flush,
                              iters=5)
            lib_ms = _timed(lambda: torch.matmul(x, w_bf16), flush)
            nbytes = planes.numel() * 4 + x.numel() * 2 + m * n * 4 + n * 4
            bound_ms, bound_by = _bound(nbytes, 2 * m * k * n)
            role = roles.get(m, "ragged, off path")
            if m == verify_m and p != 9 and m not in buckets:
                role = "verify-window shape; the window runs 9 planes: off path"
            rows.append({"name": f"qmm_bitplane P{p} M{m} K{k} N{n} ({role}; {core})",
                         "key": (p, m, k, n), "core": core, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by})
            print(f"[kernel] qmm_bitplane P={p} (M,K,N)=({m},{k},{n}) {role}: core={core} "
                  f"max_err={err:.3e} (tol {QMM_TOL:g} x {ref_max:.3g}) kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (bf16 matmul) "
                  f"bound_ms={bound_ms:.5f} ({bound_by}, {nbytes} bytes)", flush=True)
            del x, got, want, w_bf16
    del weights
    torch.cuda.empty_cache()
    return rows


def check_bitplane_rows(dev):
    """Rows that do not depend on M: at every path (K, N) and at 9 and 5
    planes, the rows of ``qmm_bitplane`` at each M of :func:`_qbp_ms`
    (decode, the verify window, every prompt bucket), taken from row 0, 4
    and 64 of one (128, K) bf16 x, equal bit for bit the same rows of the
    M 128 product: the speculative verify window then computes exactly
    what sequential decode computes. Returns the rows compared."""
    import torch
    from repro_torch.kernels import qmm_bitplane as QBP
    from repro_torch.quant import QScheme, encode

    ms = sorted(m for m in _qbp_ms() if m < 128)
    gen = torch.Generator(device=dev).manual_seed(17)
    compared = {}
    for k, n in QBP_KN:
        w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
        full_qt = encode(w, QScheme.bitplane(8))
        del w
        x = torch.randn(128, k, generator=gen, device=dev).to(torch.bfloat16)
        for p in QBP_PLANES:
            qt = full_qt.slice_planes(p - 1)
            planes = qt.codes.contiguous()
            full = QBP.qmm_bitplane(x, planes, qt.scale)
            n_rows = 0
            for m in ms:
                for start in (0, 4, 64):
                    if start + m > 128:
                        continue
                    part = QBP.qmm_bitplane(x[start:start + m], planes, qt.scale)
                    if not torch.equal(part, full[start:start + m]):
                        bad = int((part != full[start:start + m]).any(dim=1).sum())
                        raise AssertionError(
                            f"[rows] qmm_bitplane P{p} K{k} N{n}: rows {start}..{start + m} "
                            f"at M {m} differ from the M 128 product's in {bad} rows")
                    n_rows += m
            compared[f"P{p} K{k} N{n}"] = n_rows
        del full_qt, x
    print(f"[rows] qmm_bitplane rows at M {ms} (from rows 0, 4, 64) equal the M 128 "
          f"product's bit for bit at {len(compared)} (P, K, N): {compared}", flush=True)
    torch.cuda.empty_cache()
    return {"ms": ms, "rows_compared": compared}


def _bitplane_gate(what: str, checked) -> dict:
    """Fail unless every ``qmm_bitplane`` launch since the counters were
    reset ran at a (P, M, K, N) that a row of :func:`check_qmm_bitplane`
    held against the plain version, and on the tensor cores (every main
    path's activations are bf16, and ``plan`` gives bf16 x the tensor cores
    at every M); returns the per-core counts."""
    from repro_torch.kernels import qmm_bitplane as QBP

    unchecked = set(QBP.shape_launches) - set(checked)
    if unchecked:
        raise AssertionError(f"{what}: qmm_bitplane launched at unchecked shapes "
                             f"{sorted(unchecked)}")
    got = {"simt": QBP.simt_launches, "tc": QBP.tc_launches}
    if got != {"simt": 0, "tc": QBP.launches}:
        raise AssertionError(f"{what}: qmm_bitplane launches by core {got} of {QBP.launches}, "
                             "expected all on the tensor cores")
    return got


def _bitplane_counters(reset: bool = False):
    from repro_torch.kernels import paged_attn as PA
    from repro_torch.kernels import qmm as Q
    from repro_torch.kernels import qmm_bitplane as QBP

    if reset:
        Q.reset_counters()
        QBP.reset_counters()
        PA.launches = 0
    return {"qmm_bitplane": QBP.launches, "qmm": Q.launches,
            "paged_decode_attn": PA.launches}, dict(QBP.shape_launches)


def _drive(engine, trace):
    """Serve ``trace`` through ``engine.submit``/``step`` (what
    ``engine.run`` does), remembering each request's slot."""
    slot_of, out = {}, {}
    for r in trace:
        engine.submit(r)
    while engine.busy:
        for f in engine.step():
            out[f.rid] = f
        for i, st in enumerate(engine._slots):
            if st is not None:
                slot_of[st["req"].rid] = i
    return out, slot_of


def _check_served(engine, results, cfg):
    if cfg.n_layers != 18 or cfg.d_model != 2048 or cfg.vocab_size != 256000:
        raise AssertionError(f"not full-width gemma-2b: {cfg}")
    if len(results) != SERVE["n_requests"]:
        raise AssertionError(f"{len(results)} of {SERVE['n_requests']} requests finished")
    engine.allocator.check_leaks(0)
    n_gen = 0
    for f in results.values():
        gen = f.tokens[f.prompt_len:]
        if len(gen) != f.n_generated or f.n_generated < 1:
            raise AssertionError(f"request {f.rid}: {f.n_generated} tokens")
        if gen.min() < 0 or gen.max() >= cfg.vocab_size:
            raise AssertionError(f"request {f.rid}: token out of vocab")
        n_gen += f.n_generated
    return n_gen


def _code_bytes(params) -> int:
    """Bytes of every QTensor's code plane (bitplane words, int8 or packed
    int4 codes) in a param tree."""
    from repro_torch.quant import QTensor

    if isinstance(params, dict):
        return sum(_code_bytes(v) for v in params.values())
    if isinstance(params, QTensor):
        return params.codes.numel() * params.codes.element_size()
    return 0


def serve_bitplane(dev, checked):
    """Slice 4's main path: full-width gemma-2b, 8-bit bitplane weights
    written as a weights-bitplane-v1 artifact under build/ and served from
    the artifact loaded back (kv 8), then at ``set_weight_bits(4)``; the
    counters are set to 0 just before and read just after each run, and
    every ``qmm_bitplane`` launch must have run on the tensor cores at a
    (P, M, K, N) in ``checked``."""
    import shutil

    import torch
    from repro_torch.launch.serve import make_trace, serve_engine

    ship = ROOT / "build" / "ship_gemma2b_bitplane8"
    runs = {}
    _bitplane_counters(reset=True)
    t0 = time.perf_counter()
    engine, results = serve_engine(
        "gemma-2b", reduced=False, weight_bits=8, kv_bits=8, weight_layout="bitplane",
        ship_dir=str(ship), device=dev, **SERVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shapes = _bitplane_counters()
    L = engine.cfg.n_layers
    artifact_bytes = sum(f.stat().st_size for f in ship.iterdir())
    shutil.rmtree(ship)
    full_code_bytes = _code_bytes(engine.params)
    trace = make_trace(SERVE["n_requests"], engine.cfg.vocab_size, max_new=SERVE["max_new"],
                       max_prompt=SERVE["max_prompt"], seed=0)
    st0, n_times = {k: 0 for k in engine.stats}, 0
    for bits in (8, 4):
        if bits == 4:       # the same engine, after the 8-bit run's profile
            engine.set_weight_bits(4)
            st0, n_times = dict(engine.stats), len(engine.decode_times)
            _bitplane_counters(reset=True)
            t0 = time.perf_counter()
            results = engine.run(trace)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, shapes = _bitplane_counters()
        st = engine.stats
        d = {k: st[k] - st0[k] for k in
             ("decode_steps", "admitted", "prefill_tokens", "decode_seconds",
              "steady_decode_tokens")}
        n_gen = _check_served(engine, results, engine.cfg)
        want = {"qmm_bitplane": 7 * L * (d["decode_steps"] + d["admitted"]), "qmm": 0,
                "paged_decode_attn": L * d["decode_steps"]}
        if launches != want:
            raise AssertionError(f"[serve-bitplane] {bits}-bit launches {launches}, "
                                 f"expected {want}")
        if {key[0] for key in shapes} != {bits + 1}:
            raise AssertionError(f"[serve-bitplane] planes streamed {shapes}")
        cores = _bitplane_gate(f"[serve-bitplane] {bits}-bit", checked)
        times = engine.decode_times[n_times:]
        code_bytes = _code_bytes(engine.params)
        run = {"weight_bits": bits, "kv_bits": 8, "tokens_generated": n_gen,
               "decode_steps": d["decode_steps"], "prefill_tokens": d["prefill_tokens"],
               "decode_tokens_per_s": d["steady_decode_tokens"] / d["decode_seconds"],
               "mean_decode_step_ms": 1e3 * statistics.mean(times),
               "weight_bytes": engine.weight_nbytes(), "code_bytes_streamed": code_bytes,
               "code_bytes_share": code_bytes / full_code_bytes,
               "kv_pool_bytes": engine.kv_pool_nbytes(), "wall_s": wall,
               "launches": launches, "qmm_bitplane_cores": cores,
               "shape_launches": [[*k, c] for k, c in shapes.items()],
               "tokens": {r: f.tokens.tolist() for r, f in results.items()}}
        if bits == 8:
            run["artifact_bytes"] = artifact_bytes
        else:
            ref8 = runs[8]["tokens"]
            run["generated_tokens_equal_to_8bit"] = sum(
                int(a == b) for r, f in results.items()
                for a, b in zip(f.tokens[f.prompt_len:].tolist(),
                                ref8[r][f.prompt_len:]))
        print(f"[serve-bitplane] gemma-2b full width, bitplane weights at {bits} bits "
              f"(from the weights-bitplane-v1 artifact, {artifact_bytes:,} bytes on disk), "
              f"kv 8: {len(results)} requests finished, {n_gen} tokens in "
              f"{d['decode_steps']} decode steps (+{d['prefill_tokens']} prefill tokens); "
              f"steady-state decode {run['decode_tokens_per_s']:.1f} tok/s "
              f"({run['mean_decode_step_ms']:.2f} ms/step); weights {run['weight_bytes']:,} "
              f"bytes, code bytes streamed {code_bytes:,} = {run['code_bytes_share']:.4f} "
              f"of the artifact's; wall {wall:.1f} s; launches {launches}, qmm_bitplane "
              f"by core {cores}"
              + (f"; generated tokens equal to the 8-bit run's at the same position "
                 f"{run['generated_tokens_equal_to_8bit']}/{n_gen}" if bits == 4 else ""),
              flush=True)
        run["profile"] = profile_decode(engine)
        runs[bits] = run
    if abs(runs[4]["code_bytes_share"] - 5 / 9) > 1e-3:
        raise AssertionError(f"4-bit view streams {runs[4]['code_bytes_share']} of the "
                             "code bytes, expected 5/9")
    del engine
    torch.cuda.empty_cache()
    return runs


def _logit_gap(engine, tokens: np.ndarray, pos: int):
    """Top-2 logit gap of the served weights at ``pos`` of ``tokens``, from
    a dense prefill of the prefix (no KV quantization: an estimate of how
    near the tie was)."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.models import transformer as T

    toks = torch.as_tensor(tokens[:pos], dtype=torch.int64, device=engine.device)[None]
    with registry.using(engine.backend):
        logits, _ = T.prefill(engine.params, toks, engine._cfg_fp)
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def spec_bitplane(dev, want_tokens, checked, spec=SPEC, profile=True):
    """Self-speculative decoding on full-width gemma-2b: the same trace with
    ``spec`` (k 3, draft 4 bits) through ``serve_engine``; its tokens must
    equal the 8-bit bitplane run's, and every ``qmm_bitplane`` launch must
    have run on the tensor cores at a (P, M, K, N) in ``checked``."""
    import torch
    from repro_torch.launch.serve import make_trace, serve_engine

    k = spec["spec_decode"]
    t0 = time.perf_counter()
    engine, _ = serve_engine("gemma-2b", reduced=False, weight_bits=8, kv_bits=8,
                             weight_layout="bitplane", device=dev, **spec,
                             **{**SERVE, "n_requests": 0})
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    trace = make_trace(SERVE["n_requests"], engine.cfg.vocab_size, max_new=SERVE["max_new"],
                       max_prompt=SERVE["max_prompt"], seed=0)
    _bitplane_counters(reset=True)
    t0 = time.perf_counter()
    results, slot_of = _drive(engine, trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shapes = _bitplane_counters()
    st, L = engine.stats, engine.cfg.n_layers
    n_gen = _check_served(engine, results, engine.cfg)
    windows, vanilla = st["spec_steps"], st["decode_steps"] - st["spec_steps"]
    want = {"qmm_bitplane": 7 * L * (st["admitted"] + (k + 1) * windows + vanilla),
            "qmm": 0, "paged_decode_attn": L * ((k + 1) * windows + vanilla)}
    if launches != want or windows < 1:
        raise AssertionError(f"[spec] launches {launches} over {windows} windows, "
                             f"expected {want}")
    cores = _bitplane_gate(f"[spec] draft {spec['draft_bits']}", checked)
    # the verify window runs every projection at M = slots × (k + 1) under
    # the 9 planes of the served 8 bits; a prompt of that bucket does too
    w_m = engine.max_slots * (k + 1)
    n_pre = sum(engine._bucket(len(r.prompt)) == w_m for r in trace)
    at_w = sum(c for (p, m, *_), c in shapes.items() if p == 9 and m == w_m)
    if at_w != 7 * L * (windows + n_pre):
        raise AssertionError(f"[spec] {at_w} launches at 9 planes, M {w_m}: expected "
                             f"7 x {L} x ({windows} windows + {n_pre} prefills)")
    mismatches = []
    for rid, f in sorted(results.items()):
        ref = np.asarray(want_tokens[rid])
        if len(ref) != len(f.tokens) or (ref != f.tokens).any():
            n = min(len(ref), len(f.tokens))
            pos = int(np.argmax(ref[:n] != f.tokens[:n])) if (ref[:n] != f.tokens[:n]).any() \
                else n
            gap = _logit_gap(engine, ref, pos) if pos < len(ref) else None
            mismatches.append({"rid": rid, "slot": slot_of.get(rid), "position": pos,
                               "vanilla": int(ref[pos]) if pos < len(ref) else None,
                               "spec": int(f.tokens[pos]) if pos < len(f.tokens) else None,
                               "top2_logit_gap": gap})
    ms_window = 1e3 * statistics.mean(engine.decode_times)
    out = {**spec, "windows": windows, "vanilla_steps": vanilla,
           "acceptance_rate": engine.acceptance_rate(), "tokens_generated": n_gen,
           "ms_per_window": ms_window,
           "decode_tokens_per_s": engine.throughput(), "wall_s": wall, "build_s": build_s,
           "launches": launches, "qmm_bitplane_cores": cores,
           "shape_launches": [[*key, c] for key, c in shapes.items()],
           "stats": dict(st), "mismatches": mismatches}
    print(f"[spec] gemma-2b full width, bitplane 8-bit weights, kv 8, spec_decode={k} "
          f"draft_bits={spec['draft_bits']}: {len(results)} requests, {n_gen} tokens in "
          f"{windows} windows (+{vanilla} vanilla steps), acceptance "
          f"{out['acceptance_rate']:.4f}; {ms_window:.2f} ms/window, steady-state "
          f"{out['decode_tokens_per_s']:.1f} tok/s; launches {launches}, qmm_bitplane by "
          f"core {cores}; tokens equal to "
          f"[serve-bitplane] 8-bit on {len(results) - len(mismatches)}/{len(results)} "
          f"requests", flush=True)
    if mismatches:
        raise AssertionError(f"[spec] tokens differ from vanilla decode: {mismatches}")
    if spec["draft_bits"] == 8 and out["acceptance_rate"] != 1.0:
        raise AssertionError(f"[spec] a draft at the serving bits was accepted at "
                             f"{out['acceptance_rate']}, not 1: the verify window and "
                             "decode compute different logits")
    if profile:
        out["profile"] = profile_decode(engine, what="speculative windows")
    del engine
    torch.cuda.empty_cache()
    return out


def agree_bitplane(dev):
    """Reduced gemma-2b at f32 with 8-bit bitplane weights (kv 8), served
    plain, at ``set_weight_bits(2)`` and with speculation (k 3, draft 4), on
    the card (kernels) and on the CPU's plain path: equal greedy tokens."""
    import torch
    from repro_torch import configs
    from repro_torch.launch.serve import make_trace
    from repro_torch.models import transformer as T
    from repro_torch.precision.qat import quantize_param_tree
    from repro_torch.quant import PrecisionPlan
    from repro_torch.serve import ServeEngine

    plan = PrecisionPlan(model_bits=8, kv_bits=8, model_storage="int")
    cfg = configs.get_reduced("gemma-2b", dtype=torch.float32, precision=plan)
    params = quantize_param_tree(T.init_params(cfg, seed=0, device="cpu"), bits=8,
                                 layout="bitplane")
    out = {}
    for name, kw, bits in (("plain", {}, None), ("set_weight_bits(2)", {}, 2),
                           ("spec 3/4", SPEC, None)):
        toks, launched = {}, None
        for where in (dev, "cpu"):
            eng = ServeEngine(params, cfg, max_slots=4, page_size=8, max_seq_len=56,
                              backend="cuda", device=where, **kw)
            if bits:
                eng.set_weight_bits(bits)
            before = _bitplane_counters()[0]["qmm_bitplane"]
            res = eng.run(make_trace(8, cfg.vocab_size, max_new=16, max_prompt=32, seed=0))
            if where == dev:
                launched = _bitplane_counters()[0]["qmm_bitplane"] - before
            eng.allocator.check_leaks(0)
            toks[str(where)] = {r: f.tokens.tolist() for r, f in res.items()}
        same = sum(int(toks[str(dev)][r] == toks["cpu"][r]) for r in toks["cpu"])
        print(f"[check] reduced gemma-2b f32 bitplane 8-bit {name}: card kernels vs CPU "
              f"plain path — whole sequences equal {same}/8 (qmm_bitplane launches on the "
              f"card {launched})", flush=True)
        if same != 8 or not launched:
            raise AssertionError(f"[check] bitplane {name}: {same}/8 sequences equal, "
                                 f"{launched} launches")
        out[name] = {"sequences_equal": same, "card_launches": launched}
    return out

def _sq_role(r: int, c: int, on_path: bool) -> str:
    """What a row_absmax / stoch_quant case is, and whether [quantize-rows]
    launches it."""
    what = {(6000, 5000): "gisette's sample matrix", (16, 5000): "the linear path's batch",
            (13, 1001): "ragged"}.get((r, c), f"{r} x {c}")
    return f"{what}, {'path' if on_path else 'off path'}"


def check_row_absmax(dev, flush):
    """``row_absmax`` against its plain version, bit-exact (a max is exact in
    any order), at ``SQ_CASES`` in f32, at gisette's matrix and the batch in
    bf16, and at both path shapes as a view 4 bytes into its storage (the
    scalar head and tail), with an all-zero row and a row holding one NaN
    (which must come out NaN); timed beside the plain version,
    ``torch.linalg.vector_norm(x, inf)`` and the bound (x read once, the
    maxima written once), the path shapes also beside an earlier run's
    time."""
    import torch
    from repro_torch.kernels import stoch_quant as SQ

    rows = []
    gen = torch.Generator(device=dev).manual_seed(5)
    cases = [*[(r, c, torch.float32, 0) for r, c in SQ_CASES],
             (*SQ_CASES[0], torch.bfloat16, 0), (*SQ_CASES[1], torch.bfloat16, 0),
             (*SQ_CASES[0], torch.float32, 1), (*SQ_CASES[1], torch.float32, 1)]
    for r, c, dt, offset in cases:
        flat = (torch.randn(r * c + offset, generator=gen, device=dev) * 2).to(dt)
        x = flat[offset:].view(r, c)
        x[0] = 0.0
        got = SQ.row_absmax(x)
        want = SQ.row_absmax_plain(x)
        y = x.clone() if not offset else flat.clone()[offset:].view(r, c)
        y[r // 2, c // 2] = float("nan")
        got_nan = SQ.row_absmax(y)
        torch.cuda.synchronize()
        keep = torch.arange(r, device=dev) != r // 2
        if not torch.equal(got, want) or not bool(torch.isnan(got_nan[r // 2, 0])) \
                or not torch.equal(got_nan[keep], want[keep]):
            raise AssertionError(f"row_absmax ({r},{c}) {dt} offset {offset}: not bit-exact "
                                 "with the plain version (or NaN dropped)")
        ms = _timed(lambda: SQ.row_absmax(x), flush)
        plain_ms = _timed(lambda: SQ.row_absmax_plain(x), flush)
        lib_ms = _timed(lambda: torch.linalg.vector_norm(x, float("inf"), dim=1,
                                                         keepdim=True), flush)
        nbytes = r * c * x.element_size() + 4 * r
        bound_ms, bound_by = _bound(nbytes, 2 * r * c, F32_FLOPS)
        dname = ("f32" if dt == torch.float32 else "bf16") + (" view+4B" if offset else "")
        path = dt == torch.float32 and not offset and (r, c) != (13, 1001)
        role = _sq_role(r, c, path)
        before = ROW_ABSMAX_BEFORE_MS.get((r, c)) if path else None
        rows.append({"name": f"row_absmax {dname} R{r} C{c} ({role})",
                     "key": (r, c) if path else None, "max_abs_err": 0.0,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "before_ms": before})
        print(f"[kernel] row_absmax {dname} (R,C)=({r},{c}) ({role}): bit-exact, NaN kept; "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"(vector_norm inf) bound_ms={bound_ms:.5f} ({bound_by}, {nbytes} bytes) "
              f"bound/ms={bound_ms / ms:.3f}; before {before} ms", flush=True)
        del x, y, flat
    return rows


def check_stoch_quant(dev, flush):
    """``stoch_quant`` against its plain version, bit-exact, at ``SQ_CASES``
    and s ∈ ``SQ_S`` in f32 and at gisette's matrix in bf16; timed at the
    path's s beside the plain version and the bound (x and rand read once,
    the codes written once). No PyTorch call computes this function."""
    import torch
    from repro_torch import prng
    from repro_torch.kernels import stoch_quant as SQ

    rows = []
    gen = torch.Generator(device=dev).manual_seed(6)
    for r, c, dt in [*[(r, c, torch.float32) for r, c in SQ_CASES],
                     (*SQ_CASES[0], torch.bfloat16)]:
        x = (torch.randn(r, c, generator=gen, device=dev) * 2).to(dt)
        x[0] = 0.0
        rand = prng.bits(prng.PRNGKey(r + c), (r, c), device=dev, dtype=torch.int32)
        scale = SQ.row_absmax_plain(x)
        for s in SQ_S:
            got = SQ.stoch_quant(x, rand, scale, s=s)
            want = SQ.stoch_quant_plain(x, rand, scale, s=s)
            torch.cuda.synchronize()
            diff = int((got != want).sum())
            if diff or int(got.abs().max()) > s:
                raise AssertionError(f"stoch_quant ({r},{c}) {dt} s={s}: {diff} codes "
                                     "differ from the plain version (must be bit-exact)")
        s = SQ_PATH_S
        ms = _timed(lambda: SQ.stoch_quant(x, rand, scale, s=s), flush)
        plain_ms = _timed(lambda: SQ.stoch_quant_plain(x, rand, scale, s=s), flush)
        nbytes = r * c * (x.element_size() + 4 + 1) + 4 * r
        bound_ms, bound_by = _bound(nbytes, 12 * r * c, F32_FLOPS)
        dname = "f32" if dt == torch.float32 else "bf16"
        role = _sq_role(r, c, dt == torch.float32 and (r, c) != (13, 1001))
        rows.append({"name": f"stoch_quant {dname} R{r} C{c} s{s} ({role})",
                     "key": (r, c) if dt == torch.float32 else None, "max_abs_err": 0.0,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                     "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"[kernel] stoch_quant {dname} (R,C)=({r},{c}) ({role}): bit-exact at s="
              f"{list(SQ_S)} kernel_ms={ms:.4f} (s={s}) plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.5f} ({bound_by}, {nbytes} bytes)", flush=True)
        del x, rand
    return rows


def quantize_rows_path(dev, ds, flush):
    """The row-scaled quantizer entry points: ``ops.quantize_rows`` and
    ``ops.ds_quantize(scale=None)`` on gisette's sample matrix (6000 × 5000,
    f32) at s 15, then 32 ``quantize_rows`` draws of the linear path's batch
    (16 × 5000), with the quantizers' and the threefry counters set to 0
    just before and read just after. Checks the codes' range, the scales, the launch counts, and that
    the 32 draws' mean lies within 5 standard errors of x (the rounding's
    exact variance w²p(1−p) per element, over all elements and per row)."""
    import torch
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.kernels import stoch_quant as SQ
    from repro_torch.kernels import threefry as TF

    s = SQ_PATH_S
    x = torch.as_tensor(ds.a_train, dtype=torch.float32).to(dev)
    x16 = x[:16].contiguous()
    SQ.reset_counts()
    TF.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codes, scale = ops.quantize_rows(x, s, prng.PRNGKey(1))
    c1, c2, sc = ops.ds_quantize(x, s, prng.PRNGKey(2))
    draws = torch.stack([ops.dequantize_rows(*ops.quantize_rows(x16, s, prng.PRNGKey(100 + i)),
                                             s) for i in range(SQ_DRAWS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"row_absmax": SQ.row_absmax_launches, "stoch_quant": SQ.stoch_quant_launches,
                "ds_quant": SQ.launches, "ds_quant_keyed": SQ.keyed_launches,
                "threefry": TF.launches}
    shapes = dict(SQ.shape_launches)
    # quantize_rows draws its plane (one threefry launch); ds_quantize none
    want = {"row_absmax": 2 + SQ_DRAWS, "stoch_quant": 1 + SQ_DRAWS, "ds_quant": 0,
            "ds_quant_keyed": 1, "threefry": 1 + SQ_DRAWS}
    if launches != want:
        raise AssertionError(f"[quantize-rows] launches {launches}, expected {want}")
    top = max(int(codes.abs().max()), int(c1.abs().max()), int(c2.abs().max()))
    if top > s or not torch.equal(scale, SQ.row_absmax_plain(x)) or not torch.equal(sc, scale):
        raise AssertionError(f"[quantize-rows] codes reach {top} (s {s}) or wrong scales")
    # the rounding's exact variance: w²·p(1 − p), w = scale/s, p the fraction
    sc16 = scale[:16]
    t = torch.clamp(x16.abs() / sc16, 0, 1) * s
    p = t - torch.clamp(torch.floor(t), 0, s - 1)
    var = (sc16 / s) ** 2 * p * (1 - p) / SQ_DRAWS
    dev_sum = (draws.mean(0) - x16).double()
    z_all = float(dev_sum.sum() / var.double().sum().sqrt())
    z_rows = (dev_sum.sum(1) / var.double().sum(1).sqrt()).abs()
    if not (abs(z_all) <= SQ_SE and bool((z_rows <= SQ_SE).all())):
        raise AssertionError(f"[quantize-rows] mean of {SQ_DRAWS} draws off x by {z_all:.2f} "
                             f"standard errors (rows: max {float(z_rows.max()):.2f})")
    key = prng.PRNGKey(1)
    with _uncounted():            # the timing launches are no part of the path's count
        split = {"quantize_rows": _timed(lambda: ops.quantize_rows(x, s, key), flush,
                                         iters=5),
                 "threefry_plane": _timed(lambda: prng.bits(key, x.shape, device=dev,
                                                            dtype=torch.int32), flush,
                                          iters=5),
                 "row_absmax": _timed(lambda: SQ.row_absmax(x), flush),
                 "stoch_quant": None,
                 "ds_quantize": _timed(lambda: ops.ds_quantize(x, s, key), flush, iters=5)}
        rand = prng.bits(key, x.shape, device=dev, dtype=torch.int32)
        split["stoch_quant"] = _timed(lambda: SQ.stoch_quant(x, rand, scale, s=s), flush)
    SQ.reset_counts()
    out = {"shape": list(x.shape), "s": s, "launches": launches,
           "shape_launches": [[*k, n] for k, n in shapes.items()], "wall_s": wall,
           "draws_mean_z_all": z_all, "draws_mean_z_rows_max": float(z_rows.max()),
           "ms_per_call": split}
    print(f"[quantize-rows] gisette {tuple(x.shape)} f32 s={s}: codes in [-{s}, {s}], scales "
          f"equal row_absmax's plain version; {SQ_DRAWS} draws of (16, 5000): mean off x by "
          f"{z_all:.2f} standard errors (rows: max {float(z_rows.max()):.2f}; limit {SQ_SE}); "
          f"launches {launches}; ms per call: quantize_rows {split['quantize_rows']:.4f} = "
          f"threefry plane {split['threefry_plane']:.4f} + row_absmax "
          f"{split['row_absmax']:.4f} + stoch_quant {split['stoch_quant']:.4f}; ds_quantize "
          f"{split['ds_quantize']:.4f}", flush=True)
    del x, codes, c1, c2, rand
    torch.cuda.empty_cache()
    return out


def _fit(ds, plan, dev, **kw):
    """One ``train_linear`` run on the card: result, wall seconds, steps."""
    import torch
    from repro_torch.core.linear import train_linear

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train_linear(ds, plan, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = kw.get("epochs", 20) * max(ds.a_train.shape[0] // kw.get("batch", 16), 1)
    if not np.isfinite(res.losses).all() or res.x.shape != (ds.n_features,):
        raise AssertionError(f"train_linear {plan}: losses {res.losses}")
    return res, wall, steps


def cheb_path(dev, gisette):
    """§4 on the card: Fig. 9 (``CHEB_MODELS`` × ``CHEB_RUNS`` on cod-rna at
    its preset size) with the benchmark's two criteria; the SVM's ℓ1
    refetch (``REFETCH``) with the reference test's criteria; logistic
    'double' at gisette's full width for ms per step and finite losses
    falling from ln 2."""
    import math

    from repro_torch.core.linear import eval_accuracy, make_dataset
    from repro_torch.kernels import qmv as QV
    from repro_torch.kernels import stoch_quant as SQ
    from repro_torch.quant import PrecisionPlan

    SQ.reset_counts()
    QV.launches = 0
    ds = make_dataset("cod-rna", n_train=10_000, n_test=5000)
    out = {"dataset": "cod-rna", "shape": list(ds.a_train.shape), **CHEB, "models": {}}
    for model, (lr, reg, tol) in CHEB_MODELS.items():
        res = {}
        for name, (mode, bits) in CHEB_RUNS.items():
            r, wall, steps = _fit(ds, PrecisionPlan(mode, sample_bits=bits), dev,
                                  model=model, lr=lr, reg=reg, **CHEB)
            res[name] = {"losses": r.losses.tolist(), "final_loss": float(r.losses[-1]),
                         "test_acc": eval_accuracy(ds, r.x), "wall_s": wall,
                         "ms_per_step": 1e3 * wall / steps}
            print(f"[cheb] cod-rna {tuple(ds.a_train.shape)} {model} {name}: {steps} steps "
                  f"in {wall:.2f} s = {res[name]['ms_per_step']:.4f} ms/step; final loss "
                  f"{res[name]['final_loss']:.6f}, test accuracy {res[name]['test_acc']:.4f}",
                  flush=True)
        close = res["cheb_8bit"]["test_acc"] > res["fp32"]["test_acc"] - tol
        straw = res["nearest_8bit"]["test_acc"] >= res["cheb_8bit"]["test_acc"] - 0.02
        out["models"][model] = {"lr": lr, "reg": reg, "runs": res,
                                "cheb_close_to_fp32_acc": close,
                                "strawman_matches_cheb": straw}
        print(f"[cheb] {model} criteria (benchmarks/bench_chebyshev.py): cheb accuracy > "
              f"fp32 − {tol}: {close}; nearest ≥ cheb − 0.02 (the negative result): {straw}",
              flush=True)
        if not (close and straw):
            raise AssertionError(f"[cheb] {model}: a Fig. 9 criterion fails")
    ds1 = make_dataset("cod-rna", n_train=3000, n_test=1000, seed=1)
    r, wall, steps = _fit(ds1, PrecisionPlan("double", sample_bits=8), dev, **REFETCH)
    frac, acc = r.extra["refetch_frac"], eval_accuracy(ds1, r.x)
    out["refetch"] = {**REFETCH, "refetch_frac": frac, "test_acc": acc, "wall_s": wall,
                      "ms_per_step": 1e3 * wall / steps, "losses": r.losses.tolist()}
    print(f"[cheb] refetch: cod-rna seed 1 svm double 8-bit l1, {steps} steps in {wall:.2f} s "
          f"= {1e3 * wall / steps:.4f} ms/step; refetched fraction per epoch "
          f"{[round(f, 4) for f in frac]}, test accuracy {acc:.4f} (criteria: last < 0.25, "
          f"accuracy > 0.68)", flush=True)
    if not (frac[-1] < 0.25 and acc > 0.68):
        raise AssertionError(f"[cheb] refetch: fraction {frac[-1]}, accuracy {acc}")
    r, wall, steps = _fit(gisette, PrecisionPlan("double", sample_bits=4), dev,
                          **GISETTE_LOGISTIC)
    falls = bool(np.all(np.diff(np.concatenate([[math.log(2)], r.losses])) < 0))
    out["gisette_logistic"] = {**GISETTE_LOGISTIC, "shape": list(gisette.a_train.shape),
                               "losses": r.losses.tolist(), "wall_s": wall, "steps": steps,
                               "ms_per_step": 1e3 * wall / steps,
                               "test_acc": eval_accuracy(gisette, r.x)}
    print(f"[cheb] gisette {tuple(gisette.a_train.shape)} logistic double 4-bit, degree 15: "
          f"{steps} steps in {wall:.2f} s = {1e3 * wall / steps:.3f} ms/step; epoch losses "
          f"{r.losses.tolist()} (falling from ln 2: {falls})", flush=True)
    if not falls:
        raise AssertionError(f"[cheb] gisette logistic losses {r.losses} do not fall")
    # the reference's Chebyshev, straw-man and refetch gradients call no
    # Pallas kernel, and neither do the port's
    launched = {"ds_quant": SQ.launches, "ds_quant_keyed": SQ.keyed_launches,
                "qmv": QV.launches, "row_absmax": SQ.row_absmax_launches,
                "stoch_quant": SQ.stoch_quant_launches}
    if any(launched.values()):
        raise AssertionError(f"[cheb] the §4 runs launched kernels: {launched}")
    return out


def optimal_path(dev):
    """§3 on the card: Fig. 7a as ``benchmarks/bench_optimal_quant.py``
    runs it on yearprediction (uniform and optimal levels at 3 and 5 bits,
    fp32), with its three criteria; prints the level fit's seconds. The
    ``ds_quant`` and ``qmv`` counters are set to 0 just before the runs and
    read just after: the uniform runs take slice 2's kernels (one
    ``ds_quant`` and four ``qmv`` per step), the optimal-level and fp32
    runs none."""
    from repro_torch.core import linear as L
    from repro_torch.core.linear import fit_feature_levels, make_dataset
    from repro_torch.kernels import qmv as QV
    from repro_torch.kernels import stoch_quant as SQ
    from repro_torch.kernels import threefry as TF
    from repro_torch.quant import PrecisionPlan

    ds = make_dataset("yearprediction", n_train=10_000, n_test=2000)
    fit_s = {}
    for bits in (3, 5):
        t0 = time.perf_counter()
        fit_feature_levels(ds.a_train, bits)
        fit_s[bits] = time.perf_counter() - t0
    runs = {}
    SQ.reset_counts()
    QV.launches = 0
    QV.shape_launches.clear()
    TF.reset_counts()
    for bits in (3, 5):
        for opt in (False, True):
            name = f"{'opt' if opt else 'uni'}{bits}"
            r, wall, steps = _fit(ds, PrecisionPlan("double", sample_bits=bits,
                                                    optimal_levels=opt), dev, **OPTIMAL)
            runs[name] = {"final_loss": float(r.losses[-1]), "wall_s": wall,
                          "ms_per_step": 1e3 * wall / steps}
    r, wall, steps = _fit(ds, PrecisionPlan("full"), dev, **OPTIMAL)
    runs["fp32"] = {"final_loss": float(r.losses[-1]), "wall_s": wall,
                    "ms_per_step": 1e3 * wall / steps}
    launches = {"ds_quant_keyed": SQ.keyed_launches, "qmv": QV.launches,
                "ds_quant": SQ.launches, "row_absmax": SQ.row_absmax_launches,
                "stoch_quant": SQ.stoch_quant_launches, "threefry": TF.launches}
    ds_shapes = [[*k, n] for k, n in SQ.shape_launches.items()]
    qmv_shapes = [[*k, n] for k, n in QV.shape_launches.items()]
    tf_shapes = [[*k, n] for k, n in TF.shape_launches.items()]
    # the optimal-level runs draw each epoch's level planes in batched calls
    # of at most PLANE_ELEMS elements: 2 × 90 keys of the batch's rows a step
    per_step = 2 * ds.n_features * 16           # train_linear's default batch
    chunk = max(1, L.PLANE_ELEMS // per_step)
    want = {"ds_quant_keyed": 2 * steps, "qmv": 8 * steps, "ds_quant": 0, "row_absmax": 0,
            "stoch_quant": 0, "threefry": 2 * OPTIMAL["epochs"] * -(-(steps // OPTIMAL[
                "epochs"]) // chunk)}
    print(f"[optimal] launches over the five runs {launches} (expected {want}: uni3 and uni5 "
          f"one keyed ds_quant and four qmv per step, opt3 and opt5 one threefry plane per "
          f"{chunk} steps); ds_quant shapes {ds_shapes}, qmv shapes {qmv_shapes}, threefry "
          f"shapes {tf_shapes}", flush=True)
    if launches != want:
        raise AssertionError(f"[optimal] launches {launches}, expected {want}")
    for name, run in runs.items():
        print(f"[optimal] yearprediction {tuple(ds.a_train.shape)} {name}: {steps} steps in "
              f"{run['wall_s']:.2f} s = {run['ms_per_step']:.4f} ms/step, final loss "
              f"{run['final_loss']:.6f}", flush=True)
    f = {k: v["final_loss"] for k, v in runs.items()}
    checks = {"opt3_close_to_uni5": f["opt3"] <= f["uni5"] * 1.25,
              "opt_beats_uni_at_3b": f["opt3"] <= f["uni3"] * 1.02,
              "uni5_near_full": f["uni5"] < f["fp32"] * 1.3 + 1e-4}
    print(f"[optimal] criteria (benchmarks/bench_optimal_quant.py): {checks}; "
          f"fit_feature_levels {fit_s[3]:.3f} s at 3 bits, {fit_s[5]:.3f} s at 5 bits "
          f"(90 features, M 128)", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"[optimal] a Fig. 7a criterion fails: {checks}")
    return {"dataset": "yearprediction", "shape": list(ds.a_train.shape), **OPTIMAL,
            "steps": steps, "runs": runs, "checks": checks, "fit_feature_levels_s": fit_s,
            "launches": launches, "ds_shape_launches": ds_shapes,
            "qmv_shape_launches": qmv_shapes, "threefry_shape_launches": tf_shapes}


def serve_optimal(dev):
    """Full-width gemma-2b with 8-bit variance-optimal level-table weights,
    kv 8, on the slice-1 trace: every matmul takes the decode fallback, so
    ``qmm`` (and ``qmm_bitplane``) stay at 0 launches while
    ``paged_decode_attn`` runs every decode step; counters set to 0 just
    before and read just after."""
    import torch
    from repro_torch.launch.serve import serve_engine
    from repro_torch.precision import qat
    from repro_torch.quant import QTensor

    fit_s, fit = [], qat._optimal_quantize_weight

    def timed_fit(w, bits):
        """The sample, level fit and encode of one weight, timed."""
        t0 = time.perf_counter()
        qt = fit(w, bits)
        torch.cuda.synchronize()
        fit_s.append(time.perf_counter() - t0)
        return qt

    _bitplane_counters(reset=True)
    qat._optimal_quantize_weight = timed_fit
    t0 = time.perf_counter()
    try:
        engine, results = serve_engine("gemma-2b", reduced=False, weight_bits=8, kv_bits=8,
                                       optimal_levels=True, device=dev, **SERVE)
    finally:
        qat._optimal_quantize_weight = fit
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, _ = _bitplane_counters()
    n_gen = _check_served(engine, results, engine.cfg)
    st, L = engine.stats, engine.cfg.n_layers

    def weights(t):
        if isinstance(t, dict):
            return [w for v in t.values() for w in weights(v)]
        return [t] if isinstance(t, QTensor) else []

    grids = {w.scheme.grid for w in weights(engine.params)}
    want = {"qmm_bitplane": 0, "qmm": 0, "paged_decode_attn": L * st["decode_steps"]}
    if launches != want or grids != {"levels"} or not launches["paged_decode_attn"]:
        raise AssertionError(f"[serve-optimal] launches {launches} (expected {want}), "
                             f"weight grids {grids}")
    out = {"weight_bits": 8, "kv_bits": 8, "optimal_levels": True,
           "tokens_generated": n_gen, "decode_steps": st["decode_steps"],
           "prefill_tokens": st["prefill_tokens"],
           "decode_tokens_per_s": engine.throughput(),
           "mean_decode_step_ms": 1e3 * statistics.mean(engine.decode_times),
           "weight_bytes": engine.weight_nbytes(), "kv_pool_bytes": engine.kv_pool_nbytes(),
           "level_fit_encode_s": fit_s, "wall_s": wall, "launches": launches}
    print(f"[serve-optimal] gemma-2b full width, 8-bit optimal-level weights (255 levels per "
          f"weight, int16 codes), kv 8: {len(results)} requests finished, {n_gen} tokens in "
          f"{st['decode_steps']} decode steps (+{st['prefill_tokens']} prefill tokens); "
          f"steady-state decode {out['decode_tokens_per_s']:.1f} tok/s "
          f"({out['mean_decode_step_ms']:.2f} ms/step); weights {out['weight_bytes']:,} bytes; "
          f"sample, level fit and encode {sum(fit_s):.2f} s over {len(fit_s)} weights (max "
          f"{max(fit_s):.2f} s); wall {wall:.1f} s; launches {launches}", flush=True)
    out["profile"] = profile_decode(engine)
    del engine
    torch.cuda.empty_cache()
    return out


def agree_cheb(dev):
    """512 cod-rna rows on the card against the CPU's plain path: logistic
    'double' (Chebyshev), the SVM's ℓ1 refetch at 8 bits, and linreg
    'double' on 3-bit optimal levels — every sample code (and level table)
    identical, per-epoch losses within ``CHECK_LOSS_TOL``; then the reduced
    gemma-2b at f32 with 8-bit optimal-level weights (kv 8): equal tokens."""
    import torch
    from repro_torch import configs
    from repro_torch.core.linear import Dataset, make_dataset, train_linear
    from repro_torch.launch.serve import make_trace
    from repro_torch.models import transformer as T
    from repro_torch.precision.qat import quantize_param_tree
    from repro_torch.quant import PrecisionPlan
    from repro_torch.quant import qtensor as QT
    from repro_torch.serve import ServeEngine

    full = make_dataset("cod-rna", n_test=64)
    ds = Dataset(full.a_train[:CHECK_ROWS], full.b_train[:CHECK_ROWS], full.a_test,
                 full.b_test, full.name)
    cases = {"logistic double 4-bit": (PrecisionPlan("double", sample_bits=4),
                                       dict(model="logistic", lr=0.4)),
             "svm double 8-bit l1 refetch": (PrecisionPlan("double", sample_bits=8),
                                             dict(model="svm", lr=0.2, reg="ball",
                                                  refetch="l1")),
             "linreg double optimal 3-bit": (PrecisionPlan("double", sample_bits=3,
                                                           optimal_levels=True),
                                             dict(lr=0.1))}
    enc, lvq = QT._encode_zipml, QT.quantize_to_levels
    out = {}
    for name, (plan, kw) in cases.items():
        rec = {}
        for label, where in (("card", dev), ("cpu", "cpu")):
            seen = rec[label] = []

            def enc_rec(*a, **k):
                qt = enc(*a, **k)
                seen.append(qt.codes.cpu())
                return qt

            def lvq_rec(v, levels, *a, **k):
                codes, vals = lvq(v, levels, *a, **k)
                seen.extend([codes.cpu(), levels.cpu()])
                return codes, vals

            QT._encode_zipml, QT.quantize_to_levels = enc_rec, lvq_rec
            try:
                res = train_linear(ds, plan, epochs=2, device=where, **kw)
            finally:
                QT._encode_zipml, QT.quantize_to_levels = enc, lvq
            seen.append(res)
        card, cpu = rec["card"], rec["cpu"]
        rc, rp = card.pop(), cpu.pop()
        same = sum(int(torch.equal(a, b)) for a, b in zip(card, cpu))
        rel = np.abs(rc.losses - rp.losses) / np.abs(rp.losses)
        extra_ok = rc.extra is None or np.allclose(rc.extra["refetch_frac"],
                                                   rp.extra["refetch_frac"], atol=0.01)
        print(f"[check] cod-rna {CHECK_ROWS} rows {name}: codes and levels identical "
              f"{same}/{len(cpu)} (card vs CPU plain path); epoch losses card "
              f"{rc.losses.tolist()} CPU {rp.losses.tolist()} (max rel diff {rel.max():.2e}, "
              f"tol {CHECK_LOSS_TOL:g})" + ("" if rc.extra is None else
                                            f"; refetch card {rc.extra['refetch_frac']} "
                                            f"CPU {rp.extra['refetch_frac']}"), flush=True)
        if len(card) != len(cpu) or same != len(cpu) or not (rel <= CHECK_LOSS_TOL).all() \
                or not extra_ok:
            raise AssertionError(f"[check] {name}: {same}/{len(cpu)} codes identical, "
                                 f"losses {rc.losses} vs {rp.losses}")
        out[name] = {"codes_identical": same, "planes": len(cpu),
                     "losses_card": rc.losses.tolist(), "losses_cpu": rp.losses.tolist(),
                     "max_rel_loss_diff": float(rel.max())}
    plan = PrecisionPlan(model_bits=8, kv_bits=8, model_storage="int", optimal_levels=True)
    cfg = configs.get_reduced("gemma-2b", dtype=torch.float32, precision=plan)
    params = quantize_param_tree(T.init_params(cfg, seed=0, device="cpu"), bits=8,
                                 optimal=True)
    toks = {}
    for label, where in (("card", dev), ("cpu", "cpu")):
        eng = ServeEngine(params, cfg, plan=plan, max_slots=4, page_size=8, max_seq_len=56,
                          backend="cuda", device=where)
        res = eng.run(make_trace(8, cfg.vocab_size, max_new=16, max_prompt=32, seed=0))
        toks[label] = {r: f.tokens.tolist() for r, f in res.items()}
    same = sum(int(toks["card"][r] == toks["cpu"][r]) for r in toks["cpu"])
    print(f"[check] reduced gemma-2b f32 optimal-level 8-bit weights, kv 8: card vs CPU plain "
          f"path — whole sequences equal {same}/8", flush=True)
    if same != 8:
        raise AssertionError(f"[check] optimal-level serving: {same}/8 sequences equal")
    out["serve_optimal_sequences_equal"] = same
    return out


def _qout_weights(dev, gen, wbits, k, n):
    import torch
    from repro_torch.quant import QScheme, encode

    w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
    return encode(w, QScheme.int_symmetric(wbits, scaling="channel", rounding="nearest",
                                           packed=wbits == 4))


def _qout_check(x, qt, rand, bits, gate_plain):
    """One ``qmm_qout`` launch against the unfused pipeline (``qmm`` kernel
    → cast → ``ds_row_pair_ref``: bit-exact), the plain version (codes
    differ only where y after the cast or the row scale differs; with
    ``gate_plain``, on at most ``QOUT_SHARE`` of them) and the exact pair
    (the f64 product → cast → ``ds_row_pair_ref``). Returns (share of codes
    off the plain version's, max |decoded difference| from it, codes off
    the exact pair: the kernel's and the plain version's, codes counted)."""
    import torch
    from repro_torch.kernels import qmm as Q
    from repro_torch.kernels import qmm_qout as QO
    from repro_torch.kernels.ref import ds_row_pair_ref
    from repro_torch.quant.qtensor import unpack_int4

    packed, qmax, dt = qt.scheme.packed, 2 ** (bits - 1) - 1, x.dtype
    m, k = x.shape
    core = Q.plan(m, k, rand.shape[1], dt).core
    tc0 = QO.tc_launches
    c1, c2, sc = QO.qmm_qout(x, qt.codes, qt.scale, rand, qmax=qmax, packed=packed,
                             out_dtype=dt)
    if QO.tc_launches - tc0 != int(core == "tc"):
        raise AssertionError(f"qmm_qout {tuple(x.shape)} {dt}: planned core {core}, "
                             f"tensor-core launches {QO.tc_launches - tc0}")
    y = Q.qmm(x, qt.codes, qt.scale, packed=packed).to(dt)
    u1, u2, us = ds_row_pair_ref(y, rand, qmax=qmax)
    if not (torch.equal(c1, u1) and torch.equal(c2, u2) and torch.equal(sc, us)):
        raise AssertionError("qmm_qout differs from the unfused qmm → cast → encode "
                             f"pipeline: {int((c1 != u1).sum() + (c2 != u2).sum())} codes, "
                             f"{int((sc != us).sum())} scales")
    p1, p2, ps = QO.qmm_qout_plain(x, qt.codes, qt.scale, rand, qmax=qmax, packed=packed,
                                   out_dtype=dt)
    yp = Q.qmm_plain(x, qt.codes, qt.scale, packed=packed).to(dt)
    moved = (y != yp) | (sc != ps)
    d1, d2 = c1 != p1, c2 != p2
    if bool((d1 & ~moved).any()) or bool((d2 & ~moved).any()):
        raise AssertionError("qmm_qout: codes differ from the plain version's where "
                             "neither y nor the row scale does")
    share = float((d1.sum() + d2.sum()).double() / (2 * c1.numel()))
    err = float(torch.maximum((c1 * sc - p1 * ps).abs().max(),
                              (c2 * sc - p2 * ps).abs().max()))
    if gate_plain and share > QOUT_SHARE:
        raise AssertionError(f"qmm_qout: {share:.2e} of codes differ from the plain "
                             f"version's (limit {QOUT_SHARE:g})")
    # bf16 and f32 x times int8 / int4 codes are exact in f64, and so is
    # the sum to far below an f32 ulp
    c = unpack_int4(qt.codes) if packed else qt.codes
    y64 = (x.double() @ c.double()) * qt.scale.double().reshape(1, -1)
    e1, e2, _ = ds_row_pair_ref(y64.to(dt), rand, qmax=qmax)
    off_exact = int((c1 != e1).sum() + (c2 != e2).sum())
    plain_off_exact = int((p1 != e1).sum() + (p2 != e2).sum())
    return share, err, off_exact, plain_off_exact, 2 * c1.numel()


def check_qmm_qout(dev, flush):
    """``qmm_qout`` at gemma-2b's (K, N) × M 2048 / 128 / 4 and a ragged
    shape, int8 and int4 weights, bf16 and f32 x, 8- and 4-bit pairs, on
    the draws of each of ``QOUT_SEEDS``: each bit-exact against the unfused
    pipeline, as near the exact pair as ``QOUT_SEEDS``' note says, and, on
    the first seed's draws, within ``QOUT_SHARE`` of the plain version and
    timed (bf16 x, 8-bit pairs) beside the plain version, the bf16
    ``torch.matmul`` of the same (M, K, N) (the yardstick of the product; no
    PyTorch call computes the fused function) and the bound."""
    import torch
    from repro_torch.kernels import qmm as Q
    from repro_torch.kernels import qmm_qout as QO

    rows, worst, worst_later = [], 0.0, 0.0
    exact = collections.defaultdict(lambda: [0, 0, 0])   # key → [kernel, plain, codes]
    shapes = [(m, k, n) for m in QOUT_MS for k, n in QBP_KN] + [QBP_RAGGED]
    for seed in QOUT_SEEDS:
        timed = seed == QOUT_SEEDS[0]
        gen = torch.Generator(device=dev).manual_seed(seed)
        for wbits in (8, 4):
            weights = {}
            for m, k, n in shapes:
                if (k, n) not in weights:
                    weights[(k, n)] = _qout_weights(dev, gen, wbits, k, n)
                qt = weights[(k, n)]
                rand = torch.randint(-2 ** 31, 2 ** 31, (m, n), generator=gen, device=dev,
                                     dtype=torch.int32)
                x32 = torch.randn(m, k, generator=gen, device=dev)
                key = (qt.scheme.packed, m, k, n)
                shares, errs = {}, {}
                for dt in (torch.bfloat16, torch.float32):
                    for bits in (8, 4):
                        share, err, off, plain_off, codes = _qout_check(
                            x32.to(dt), qt, rand, bits, gate_plain=timed)
                        shares[(dt, bits)], errs[(dt, bits)] = share, err
                        for i, v in enumerate((off, plain_off, codes)):
                            exact[key][i] += v
                if not timed:
                    worst_later = max(worst_later, *shares.values())
                    del rand, x32
                    continue
                worst = max(worst, *shares.values())
                x, err = x32.to(torch.bfloat16), errs[(torch.bfloat16, 8)]
                w_bf16 = qt.decode().to(torch.bfloat16)
                kw = dict(qmax=127, packed=qt.scheme.packed, out_dtype=torch.bfloat16)
                iters = 10 if m * n >= 2048 * 16384 else 20
                ms = _timed(lambda: QO.qmm_qout(x, qt.codes, qt.scale, rand, **kw), flush,
                            iters)
                plain_ms = _timed(lambda: QO.qmm_qout_plain(x, qt.codes, qt.scale, rand,
                                                            **kw), flush, iters)
                mm_ms = _timed(lambda: torch.matmul(x, w_bf16), flush, iters)
                nbytes = x.numel() * 2 + qt.codes.numel() + n * 4 + rand.numel() * 4 \
                    + 2 * m * n + m * 4
                bound_ms, bound_by = _bound(nbytes, 2 * m * k * n)
                role = {2048: "training batch", 128: "prefill", 4: "decode"}.get(m, "ragged")
                core = Q.plan(m, k, n, x.dtype).core
                rows.append({"name": f"qmm_qout int{wbits} M{m} K{k} N{n} bf16 x, 8-bit "
                                     f"pair ({role})", "key": key, "core": core,
                             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             "library_ms": None, "matmul_ms": mm_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by,
                             "plain_code_share": {f"{str(d)[6:]} {b}-bit": v
                                                  for (d, b), v in shares.items()}})
                print(f"[kernel] qmm_qout int{wbits} (M,K,N)=({m},{k},{n}) {role}: "
                      f"core={core} bit-exact vs qmm → cast → encode (bf16/f32 x, 8/4-bit "
                      f"pairs); codes off the plain version {max(shares.values()):.2e} "
                      f"(limit {QOUT_SHARE:g}); kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                      f"bf16 matmul_ms={mm_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}, "
                      f"{nbytes} bytes)", flush=True)
                del rand, x32, x, w_bf16
            del weights
    torch.cuda.empty_cache()
    totals = [sum(v[i] for v in exact.values()) for i in range(3)]
    for m in sorted({key[1] for key in exact}):
        off, plain_off, codes = (sum(v[i] for key, v in exact.items() if key[1] == m)
                                 for i in range(3))
        print(f"[kernel] qmm_qout M {m}: codes off the exact pair over seeds {QOUT_SEEDS}: "
              f"kernel {off / codes:.2e} (limit {QOUT_SHARE:g}), plain version "
              f"{plain_off / codes:.2e}; by (packed, K, N): "
              f"{ {(key[0], *key[2:]): round(v[0] / v[2], 8) for key, v in exact.items() if key[1] == m} }",
              flush=True)
        if off > QOUT_SHARE * codes:
            raise AssertionError(f"qmm_qout M {m}: {off} of {codes} codes differ from the "
                                 f"exact pair (limit {QOUT_SHARE:g})")
    if totals[0] > totals[1]:
        raise AssertionError(f"qmm_qout: {totals[0]} codes off the exact pair, more than "
                             f"the plain version's {totals[1]}")
    print(f"[kernel] qmm_qout: largest share of codes off the plain version {worst:.2e} "
          f"(seed {QOUT_SEEDS[0]}; seeds {QOUT_SEEDS[1:]}: {worst_later:.2e}); codes off "
          f"the exact pair over all draws: kernel {totals[0]}, plain version {totals[1]} "
          f"of {totals[2]}", flush=True)
    for r in rows:
        off, plain_off, codes = exact[r["key"]]
        r["exact_code_share"] = {"kernel": off / codes, "plain": plain_off / codes}
    return rows


def check_qmm_t_unembed(dev, flush):
    """``qmm_t`` at the tied unembed's shapes — h (M, 2048) against the
    (256000, 2048) table codes, M 4 (decode) and 1 (a prefill's readout),
    int8 and int4, bf16 h — against its plain version (rel 1e-5 of the
    largest output), timed beside the bf16 ``torch.matmul`` and the bound
    (the table's code bytes at HBM bandwidth)."""
    import torch
    from repro_torch.kernels import qmm_t as QT
    from repro_torch.quant import QScheme, encode

    k, n = UNEMBED_KN
    rows = []
    gen = torch.Generator(device=dev).manual_seed(12)
    for bits in (8, 4):
        packed = bits == 4
        w = torch.randn(k, n, generator=gen, device=dev) * n ** -0.5
        qt = encode(w, QScheme.int_symmetric(bits, scaling="channel", rounding="nearest",
                                             packed=packed))
        del w
        w_bf16 = qt.decode(torch.bfloat16)
        for m in (SERVE["max_slots"], 1):
            g = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
            core, err, ref_max = _qmm_t_checked(g, qt, packed, f"qmm_t unembed int{bits} M{m}")
            if core != "stream":
                raise AssertionError(f"qmm_t unembed int{bits} M{m}: planned on {core}")
            ms = _timed(lambda: QT.qmm_t(g, qt.codes, qt.scale, packed=packed), flush)
            plain_ms = _timed(lambda: QT.qmm_t_plain(g, qt.codes, qt.scale, packed=packed),
                              flush, iters=5)
            lib_ms = _timed(lambda: torch.matmul(g, w_bf16.T), flush)
            nbytes = g.numel() * 2 + qt.codes.numel() + n * 4 + m * k * 4
            bound_ms, bound_by = _bound(nbytes, 2 * m * k * n)
            role = "decode readout" if m > 1 else "prefill readout"
            rows.append({"name": f"qmm_t int{bits} M{m} K{k} N{n} (tied unembed, {role})",
                         "key": (packed, m, k, n), "core": core, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by})
            print(f"[kernel] qmm_t int{bits} (M,K,N)=({m},{k},{n}) tied unembed, {role}: "
                  f"core={core} max_err={err:.3e} (tol {QMM_TOL:g} x {ref_max:.3g}) kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (bf16 matmul) "
                  f"bound_ms={bound_ms:.4f} ({bound_by}, {nbytes} bytes)", flush=True)
            del g
        del qt, w_bf16
    torch.cuda.empty_cache()
    return rows


def _layer0_inputs(params, cfg, tokens):
    """The inputs of layer 0's seven projections for one batch, flattened to
    (B·S, ·): the attention input (q, k, v), the attention mix (o), the MLP
    input (gate, up) and gelu(gate)·up (down), computed through the int8
    model's own layers (``qmm``)."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models.layers import (apply_rope, dense, embed, gelu_tanh, layer_view,
                                           rmsnorm)

    spec = cfg.attn_spec
    lay = layer_view(params["layers"], 0)
    x0 = embed(params["embed"], tokens, cfg.dtype).to(cfg.dtype)
    b, s, d = x0.shape
    z1 = rmsnorm(lay["ln1"], x0)
    att = lay["attn"]
    q = dense(att["q"], z1).reshape(b, s, spec.n_heads, spec.head_dim)
    k = dense(att["k"], z1).reshape(b, s, spec.n_kv_heads, spec.head_dim)
    v = dense(att["v"], z1).reshape(b, s, spec.n_kv_heads, spec.head_dim)
    pos = torch.arange(s, device=x0.device)
    mix = A.chunked_attention(apply_rope(q, pos, spec.rope_theta),
                              apply_rope(k, pos, spec.rope_theta), v, spec)
    mix = mix.reshape(b, s, spec.n_heads * spec.head_dim)
    z2 = rmsnorm(lay["ln2"], x0 + dense(att["o"], mix))
    a = gelu_tanh(dense(lay["mlp"]["gate"], z2)) * dense(lay["mlp"]["up"], z2)
    ins = {"q": z1, "k": z1, "v": z1, "o": mix, "gate": z2, "up": z2, "down": a}
    ws = {**{n: att[n]["w"] for n in "qkvo"},
          **{n: lay["mlp"][n]["w"] for n in ("gate", "up", "down")}}
    return {n: (ins[n].reshape(b * s, -1), ws[n]) for n in ins}


def act_quant_path(dev):
    """Slice 6's main path: the activation channel on full-width gemma-2b at
    int8. One 4 × 512 batch of the training path's TokenStream; the inputs
    of layer 0's seven projections; ``ds_project`` through each, with the
    ``qmm_qout`` and ``qmm`` counters set to 0 just before and read just
    after (7 and 0); every pair's codes in ±127 with |c1 − c2| ≤ 1 and equal
    to the unfused pipeline's from the same rand plane; 32 draws of the gate
    pair within 5 standard errors of y; then 5 SGD steps of a full-width
    ``ds_mlp`` block (layer 0's bf16 MLP weights, tanh GELU) on the
    attention input with target ``roll(x, 1)``: the loss must fall."""
    import torch
    from repro_torch import configs, prng
    from repro_torch.data.pipeline import TokenStream, TokenStreamConfig
    from repro_torch.kernels import qmm as Q
    from repro_torch.kernels import qmm_qout as QO
    from repro_torch.kernels.ref import ds_row_pair_ref
    from repro_torch.models import transformer as T
    from repro_torch.precision import act_quant as AQ
    from repro_torch.precision.qat import quantize_param_tree

    cfg = configs.get_config("gemma-2b")
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    mlp0 = {n: {"w": params["layers"]["mlp"][n]["w"][0].clone()}
            for n in ("gate", "up", "down")}
    params = quantize_param_tree(params, bits=8)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b, s = ACT["batch"], ACT["seq"]
    stream = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                           global_batch=b))
    tokens = torch.from_numpy(stream.next_batch()["tokens"]).to(dev)
    with torch.no_grad():
        ins = _layer0_inputs(params, cfg, tokens)
    key = prng.PRNGKey(18)
    keys = {n: prng.fold_in(key, i) for i, n in enumerate(ins)}
    torch.cuda.synchronize()
    QO.reset_counters()
    Q.reset_counters()
    t0 = time.perf_counter()
    pairs = {n: AQ.ds_project(x, w, keys[n], bits=8) for n, (x, w) in ins.items()}
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = {"qmm_qout": QO.launches, "qmm": Q.launches}
    shapes = dict(QO.shape_launches)
    if launches != {"qmm_qout": len(ins), "qmm": 0}:
        raise AssertionError(f"[act-quant] launches {launches}, expected qmm_qout "
                             f"{len(ins)} and qmm 0")
    qout_cores = _core_gate("[act-quant]", QO)
    checks = {}
    for n, pair in pairs.items():
        x, w = ins[n]
        rand = prng.bits(keys[n], (x.shape[0], w.shape[-1]), device=dev, dtype=torch.int32)
        y = Q.qmm(x, w.codes, w.scale).to(x.dtype)
        u1, u2, us = ds_row_pair_ref(y, rand, qmax=127)
        equal = torch.equal(pair.codes, u1) and torch.equal(pair.codes2, u2) \
            and torch.equal(pair.scale, us)
        gap = int((pair.codes.int() - pair.codes2.int()).abs().max())
        top = max(int(pair.codes.abs().max()), int(pair.codes2.abs().max()))
        checks[n] = {"shape": list(pair.codes.shape), "unfused_equal": equal,
                     "max_pair_gap": gap, "max_code": top}
        if not equal or gap > 1 or top > 127:
            raise AssertionError(f"[act-quant] {n}: {checks[n]}")
    # unbiasedness: the mean of 32 draws of the gate pair (each draw's two
    # planes averaged) against y, in units of its exact standard error
    x, w = ins["gate"]
    y = Q.qmm(x, w.codes, w.scale).to(x.dtype).to(torch.float32)
    acc = torch.zeros_like(y)
    for i in range(ACT["draws"]):
        pr = AQ.ds_project(x, w, prng.fold_in(keys["gate"], 1000 + i), bits=8)
        acc += (pr.decode() + pr.decode2()) / 2
    sc = pr.scale
    t = y / sc
    p = t - torch.floor(t)
    var = sc * sc * p * (1 - p) / (2 * ACT["draws"])
    dev_sum = (acc / ACT["draws"] - y).double()
    z_all = float(dev_sum.sum() / var.double().sum().sqrt())
    z_rows = (dev_sum.sum(1) / var.double().sum(1).sqrt()).abs()
    if not (abs(z_all) <= ACT["se"] and bool((z_rows <= ACT["se"]).all())):
        raise AssertionError(f"[act-quant] mean of {ACT['draws']} gate draws off y by "
                             f"{z_all:.2f} standard errors (rows max {float(z_rows.max()):.2f})")
    del pairs, acc, y, t, p, var, dev_sum
    Q.reset_counters()
    QO.reset_counters()
    # a full-width ds_mlp block: 5 plain SGD steps on layer 0's bf16 weights
    xm = ins["q"][0]
    target = torch.roll(xm, 1, dims=1).to(torch.float32)
    del params, ins
    torch.cuda.empty_cache()

    def loss_of(p, k):
        y = AQ.ds_mlp(p, xm, k, act=cfg.mlp_act, bits=8)
        return torch.mean((y.to(torch.float32) - target) ** 2)

    losses, step_ms = [], []
    p = mlp0
    for i in range(ACT["steps"]):
        pp = {n: {"w": v["w"].clone().requires_grad_()} for n, v in p.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_of(pp, prng.fold_in(key, 100 + i))
        loss.backward()
        p = {n: {"w": (v["w"] - ACT["lr"] * v["w"].grad).detach().to(torch.bfloat16)}
             for n, v in pp.items()}
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss.item())
    with torch.no_grad():
        losses.append(float(loss_of(p, prng.fold_in(key, 100 + ACT["steps"]))))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[act-quant] ds_mlp losses do not fall: {losses}")
    out = {"tokens": [b, s], "setup_s": setup_s, "ds_project_s": path_s,
           "launches": launches, "qmm_qout_launches_by_core": qout_cores,
           "shape_launches": [[*k_, v] for k_, v in shapes.items()], "pairs": checks, "draws": ACT["draws"], "draws_mean_z_all": z_all,
           "draws_mean_z_rows_max": float(z_rows.max()), "ds_mlp_lr": ACT["lr"],
           "ds_mlp_losses": losses, "ds_mlp_step_ms": step_ms}
    print(f"[act-quant] gemma-2b full width int8, layer 0, {b} x {s} tokens of the training "
          f"stream: ds_project through q, k, v, o, gate, up, down in {path_s:.3f} s; "
          f"launches {launches}, qmm_qout by core {qout_cores}; every pair in ±127, |c1 − c2| ≤ 1, equal to qmm → cast → "
          f"encode; {ACT['draws']} gate draws' mean off y by {z_all:.2f} standard errors "
          f"(rows max {float(z_rows.max()):.2f}; limit {ACT['se']}); ds_mlp lr {ACT['lr']} "
          f"losses {[round(v, 6) for v in losses]}, ms per step "
          f"{[round(v, 1) for v in step_ms]}", flush=True)
    torch.cuda.empty_cache()
    return out


def serve_embed(dev, slice1, checked):
    """Full-width gemma-2b with 8-bit weights and an 8-bit embedding table
    (``quantize_param_tree(..., include_embedding=True)``), kv 8, built into
    a ``ServeEngine`` directly, on the slice-1 trace: ``embed`` gathers code
    rows, every readout streams the table through ``qmm_t``. Counters set
    to 0 just before and read just after: ``qmm_t`` one launch per prefill
    and per decode step, ``qmm`` and ``paged_decode_attn`` as in slice 1."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import paged_attn as PA
    from repro_torch.kernels import qmm as Q
    from repro_torch.kernels import qmm_t as QT
    from repro_torch.launch.serve import make_trace
    from repro_torch.models import transformer as T
    from repro_torch.precision.qat import quantize_param_tree
    from repro_torch.quant import PrecisionPlan
    from repro_torch.serve import ServeEngine

    plan = PrecisionPlan(model_bits=8, kv_bits=8, model_storage="int")
    cfg = configs.get_config("gemma-2b", precision=plan)
    params = quantize_param_tree(T.init_params(cfg, seed=0, device=dev), bits=8,
                                 include_embedding=True)
    table = params["embed"]["table"]
    table_bytes = table.codes.numel() * table.codes.element_size()
    engine = ServeEngine(params, cfg, plan=plan, max_slots=SERVE["max_slots"],
                         page_size=SERVE["page_size"],
                         max_seq_len=SERVE["max_prompt"] + SERVE["max_new"] + SERVE["page_size"],
                         backend="cuda", device=dev)
    del params
    trace = make_trace(SERVE["n_requests"], cfg.vocab_size, max_new=SERVE["max_new"],
                       max_prompt=SERVE["max_prompt"], seed=0)
    Q.reset_counters()
    QT.reset_counters()
    PA.launches = 0
    t0 = time.perf_counter()
    results = engine.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"qmm_t": QT.launches, "qmm": Q.launches, "paged_decode_attn": PA.launches}
    qt_shapes = dict(QT.shape_launches)
    qmm_shapes = dict(Q.shape_launches)
    qmm_cores = _core_gate("[serve-embed]", Q, checked)
    qmm_t_cores = _qmm_t_core_gate("[serve-embed]", "stream")
    n_gen = _check_served(engine, results, engine.cfg)
    st, L = engine.stats, cfg.n_layers
    want = {"qmm_t": st["admitted"] + st["decode_steps"],
            "qmm": 7 * L * (st["admitted"] + st["decode_steps"]),
            "paged_decode_attn": L * st["decode_steps"]}
    if launches != want or not launches["qmm_t"]:
        raise AssertionError(f"[serve-embed] launches {launches}, expected {want}")
    base = slice1[2]
    out = {"weight_bits": 8, "kv_bits": 8, "table_code_bytes": table_bytes,
           "tokens_generated": n_gen, "decode_steps": st["decode_steps"],
           "prefill_tokens": st["prefill_tokens"],
           "decode_tokens_per_s": engine.throughput(),
           "mean_decode_step_ms": 1e3 * statistics.mean(engine.decode_times),
           "weight_bytes": engine.weight_nbytes(), "wall_s": wall, "launches": launches,
           "qmm_launches_by_core": qmm_cores, "qmm_t_launches_by_core": qmm_t_cores,
           "qmm_shape_launches": [[*k, v] for k, v in qmm_shapes.items()],
           "qmm_t_shape_launches": [[*k, v] for k, v in qt_shapes.items()],
           "slice1_8_8": {"decode_tokens_per_s": base["decode_tokens_per_s"],
                          "mean_decode_step_ms": base["mean_decode_step_ms"],
                          "weight_bytes": base["weight_bytes"]}}
    print(f"[serve-embed] gemma-2b full width, 8-bit weights and 8-bit embedding table "
          f"({table_bytes:,} code bytes), kv 8: {len(results)} requests finished, {n_gen} "
          f"tokens in {st['decode_steps']} decode steps (+{st['prefill_tokens']} prefill "
          f"tokens); steady-state decode {out['decode_tokens_per_s']:.1f} tok/s "
          f"({out['mean_decode_step_ms']:.2f} ms/step) against slice 1's 8/8 "
          f"{base['decode_tokens_per_s']:.1f} tok/s ({base['mean_decode_step_ms']:.2f} "
          f"ms/step) in this run; weights {out['weight_bytes']:,} bytes (slice 1: "
          f"{base['weight_bytes']:,}); launches {launches}; qmm_t shapes {qt_shapes}, by "
          f"core {qmm_t_cores}",
          flush=True)
    out["profile"] = profile_decode(engine)
    del engine
    torch.cuda.empty_cache()
    return out


def agree_embed_act(dev):
    """The reduced gemma-2b at f32 with quantized embedding tables at 8 and
    4 bits served on the card and on the CPU's plain path: equal tokens;
    then one reduced ``ds_mlp`` step (f32, 64 rows, d 64, d_ff 128) on both:
    every activation code plane equal, gradients within ``ACT_CHECK_TOL``
    of the largest entry."""
    import torch
    from repro_torch import configs, prng
    from repro_torch.launch.serve import make_trace
    from repro_torch.models import transformer as T
    from repro_torch.precision import act_quant as AQ
    from repro_torch.precision.qat import quantize_param_tree
    from repro_torch.quant import PrecisionPlan
    from repro_torch.serve import ServeEngine

    out = {}
    for bits in (8, 4):
        plan = PrecisionPlan(model_bits=bits, kv_bits=bits, model_storage="int")
        cfg = configs.get_reduced("gemma-2b", dtype=torch.float32, precision=plan)
        params = quantize_param_tree(T.init_params(cfg, seed=0, device="cpu"), bits=bits,
                                     include_embedding=True)
        toks = {}
        for label, where in (("card", dev), ("cpu", "cpu")):
            eng = ServeEngine(params, cfg, max_slots=4, page_size=8, max_seq_len=56,
                              backend="cuda", device=where)
            res = eng.run(make_trace(8, cfg.vocab_size, max_new=16, max_prompt=32, seed=0))
            toks[label] = {r: f.tokens.tolist() for r, f in res.items()}
        same = sum(int(toks["card"][r] == toks["cpu"][r]) for r in toks["cpu"])
        print(f"[check] reduced gemma-2b f32 int{bits} weights and int{bits} embedding table: "
              f"card vs CPU plain path — whole sequences equal {same}/8", flush=True)
        if same != 8:
            raise AssertionError(f"[check] quantized-table serving int{bits}: {same}/8 equal")
        out[f"embed_int{bits}_sequences_equal"] = same
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(0, 1, (64, 64)).astype(np.float32))
    p = {n: {"w": torch.from_numpy((rng.normal(0, 1, shp) * 0.2).astype(np.float32))}
         for n, shp in (("gate", (64, 128)), ("up", (64, 128)), ("down", (128, 64)))}
    pair = AQ.ds_pair
    rec = {}
    for label, where in (("card", dev), ("cpu", "cpu")):
        seen = rec[label] = []

        def pair_rec(*a, **k):
            qt = pair(*a, **k)
            seen.extend([qt.codes.cpu(), qt.codes2.cpu()])
            return qt

        pp = {n: {"w": v["w"].to(where).requires_grad_()} for n, v in p.items()}
        xw = x.to(where)
        AQ.ds_pair = pair_rec
        try:
            loss = torch.mean((AQ.ds_mlp(pp, xw, prng.PRNGKey(7), act="gelu")
                               - torch.roll(xw, 1, dims=1)) ** 2)
            loss.backward()
        finally:
            AQ.ds_pair = pair
        seen.append((loss.item(), {n: v["w"].grad.cpu() for n, v in pp.items()}))
    (lc, gc), (lp, gp) = rec["card"].pop(), rec["cpu"].pop()
    same = sum(int(torch.equal(a, b)) for a, b in zip(rec["card"], rec["cpu"]))
    rel = max(float((gc[n] - gp[n]).abs().max() / gp[n].abs().max()) for n in gp)
    print(f"[check] reduced ds_mlp step f32: activation code planes equal {same}/"
          f"{len(rec['cpu'])} (card vs CPU plain path); loss {lc:.7f} vs {lp:.7f}; gradients "
          f"max rel diff {rel:.2e} (tol {ACT_CHECK_TOL:g})", flush=True)
    if same != len(rec["cpu"]) or len(rec["card"]) != len(rec["cpu"]) or rel > ACT_CHECK_TOL:
        raise AssertionError(f"[check] ds_mlp: {same}/{len(rec['cpu'])} planes equal, "
                             f"gradients rel {rel}")
    out["ds_mlp"] = {"planes_equal": same, "planes": len(rec["cpu"]), "loss_card": lc,
                     "loss_cpu": lp, "grad_max_rel_diff": rel}
    return out


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _ssd_inputs(dev, shape, dtype, init, seed=0):
    """The model's laws at random: x N(0, .25), dt = softplus(N(0, 1) − 1),
    logdec = dt · −(1..H) (a_log = log(1..H), the init's), B and C N(0, .09),
    x/B/C in ``dtype`` cut as strided views from one projection row, as the
    model's are; an initial state N(0, 1) when ``init``."""
    import torch

    b, nc, L, h, p, n = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = dict(device=dev, dtype=torch.float32)
    row = torch.randn(b, nc, L, h * p + 2 * n, generator=g, **f32)
    row[..., :h * p] *= 0.5
    row[..., h * p:] *= 0.3
    row = row.to(dtype)
    x = row[..., :h * p].reshape(b, nc, L, h, p)
    bm, cm = row[..., h * p:h * p + n], row[..., h * p + n:]
    dt = torch.nn.functional.softplus(torch.randn(b, nc, L, h, generator=g, **f32) - 1)
    logdec = dt * -torch.arange(1, h + 1, **f32)
    st = torch.randn(b, h, p, n, generator=g, **f32) if init else None
    return x, dt, logdec, bm, cm, st


def check_ssd(dev, flush, cases=SSD_CASES):
    """``ssd_chunk_scan`` against its plain version at ``cases``: y
    within ``SSD_TOL`` and the final state within ``SSD_STATE_TOL`` (rtol
    and atol), both finite; each row on the core ``ssd.plan`` picks from
    x's dtype (bf16 on the tensor cores, f32 on the SIMT kernel), checked
    through the wrapper's per-core counter; timed beside the plain version
    and the bound (no PyTorch call computes SSD)."""
    import torch
    from repro_torch.kernels import ssd as SD

    rows = []
    for shape, dname, init, role in cases:
        dtype = getattr(torch, dname)
        args = _ssd_inputs(dev, shape, dtype, init)
        before = SD.tc_launches
        y, st = SD.ssd_chunk_scan(*args)
        core = "tc" if SD.tc_launches > before else "simt"
        if core != SD.plan(dtype, *shape[2:]).core:
            raise AssertionError(f"ssd_chunk_scan {shape} {dname}: ran on {core}")
        y_ref, st_ref = SD.ssd_chunk_scan_plain(*args)
        torch.cuda.synchronize()
        errs = {}
        for what, got, want, tol in (("y", y.float(), y_ref.float(), SSD_TOL[dname]),
                                     ("state", st, st_ref, SSD_STATE_TOL)):
            if not torch.isfinite(got).all():
                raise AssertionError(f"ssd_chunk_scan {shape} {dname}: {what} not finite")
            errs[what] = float((got - want).abs().max())
            if not bool(((got - want).abs() <= tol + tol * want.abs()).all()):
                raise AssertionError(f"ssd_chunk_scan {shape} {dname}: {what} max err "
                                     f"{errs[what]} beyond rtol = atol = {tol}")
        if not all(torch.equal(a, b) for a, b in zip(SD.ssd_chunk_scan(*args), (y, st))):
            raise AssertionError(f"ssd_chunk_scan {shape} {dname}: not run-to-run identical")
        ms = _timed(lambda: SD.ssd_chunk_scan(*args), flush)
        plain_ms = _timed(lambda: SD.ssd_chunk_scan_plain(*args), flush)
        b, nc, L, h, p, n = shape
        esz = y.element_size()
        nbytes = (esz * b * nc * L * (2 * h * p + 2 * n) + 4 * 2 * b * nc * L * h
                  + 4 * b * h * p * n * (2 if init else 1))
        # the three contractions of every (batch, chunk), C·Bᵀ once (one
        # group) and the causal halves only: the least work for the function,
        # at the rate of the unit that does it (bf16 tensor cores for bf16
        # x, whose core runs the three contractions other than C·Bᵀ on f32
        # operands in three bf16 pieces: its own floor is that work three
        # times; f32 CUDA cores for f32 x)
        tri = L * (L + 1) // 2
        ops = 2 * b * nc * (tri * n + tri * h * p + 2 * L * h * p * n)
        rate = BF16_FLOPS if core == "tc" else F32_FLOPS
        bound_ms, bound_by = _bound(nbytes, ops, rate)
        floor_ms = None
        if core == "tc":
            floor_ms = max(2 * b * nc * (tri * n + 3 * (tri * h * p + 2 * L * h * p * n))
                           / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        name = (f"ssd_chunk_scan {dname} B{b} NC{nc} L{L} H{h} P{p} N{n}"
                f"{' init' if init else ''} ({role})")
        rows.append({"name": name, "key": (dname, *shape, init), "core": core,
                     "max_abs_err": max(errs.values()), "y_err": errs["y"],
                     "state_err": errs["state"], "ms": ms, "plain_ms": plain_ms,
                     "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
                     "three_pass_floor_ms": floor_ms})
        floor = "" if floor_ms is None else f" three_pass_floor_ms={floor_ms:.4f}"
        print(f"[kernel] {name}: core={core} y max_err={errs['y']:.3e} (rtol = atol = "
              f"{SSD_TOL[dname]:g}) state max_err={errs['state']:.3e} (rtol = atol = "
              f"{SSD_STATE_TOL:g}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}; {ops / 1e9:.2f} GFLOP at "
              f"{rate / 1e12:g} TFLOP/s, {nbytes / 1e6:.1f} MB){floor}", flush=True)
        del args, y, st, y_ref, st_ref
        torch.cuda.empty_cache()
    return rows


def profile_steps(step, params, state, tok, steps: int = 5):
    """``profile_window`` over ``steps`` greedy decode steps of the legacy
    loop, after one untimed step."""
    carry = list(step(params, state, tok)[1:])          # [next tokens, state]

    def advance():
        _, carry[0], carry[1] = step(params, carry[1], carry[0][:, None])
    return profile_window(advance, steps, "legacy decode steps")


def _consistency(T, step, params, prompts, cfg, tag):
    """prefill(prompt) against prefill(prompt[:, :-1]) + one decode step:
    the two last-position logits over the real vocab (the pad is masked to
    -1e30), and the seconds of the whole prefill. Both prefills reserve
    the prompt's length in any KV cache (``pad_to``), so the decode step
    appends its row after prompt[:, :-1] instead of overwriting the last
    one (the ring cursor is ``min(length, rows − 1)``)."""
    import torch

    pad = prompts.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full, _ = T.prefill_state(params, prompts, cfg, pad_to=pad)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    _, state = T.prefill_state(params, prompts[:, :-1], cfg, pad_to=pad)
    last, _, _ = step(params, state, prompts[:, -1:].to(torch.int32))
    v = cfg.vocab_size
    full, last = full[:, :v].float(), last[:, -1, :v].float()
    if not (torch.isfinite(full).all() and torch.isfinite(last).all()):
        raise AssertionError(f"{tag} logits not finite")
    out = {"max_abs": float((last - full).abs().max()), "logit_scale": float(full.abs().max()),
           "argmax_equal": int((last.argmax(-1) == full.argmax(-1)).sum())}
    return out, full, last, prefill_s


# the legacy loop's full-width runs of slices 7 and 9: (tag, width, serve()
# shape, (weight, KV) bits of each run, f32 consistency gate)
SSM_RUNS = {
    "mamba2-780m": ("[serve-mamba]", MAMBA_WIDTH, MAMBA, [(b, 0) for b in MAMBA_BITS],
                    MAMBA_CONSISTENCY_TOL),
    "zamba2-2.7b": ("[serve-hybrid]", HYBRID_WIDTH, HYBRID, [(b, b) for b in HYBRID_BITS],
                    HYBRID_CONSISTENCY_TOL),
}


def _ssm_width(cfg) -> tuple:
    spec = cfg.ssm_spec
    width = (cfg.n_layers, cfg.d_model, spec.n_heads, spec.head_dim, spec.d_state)
    return width + (cfg.shared_attn_every,) if cfg.family == "hybrid" else width


def serve_ssm(dev, ssd_rows, qmm_rows, arch="mamba2-780m"):
    """The legacy loop's main path on a Mamba2 stack — slice 7's
    mamba2-780m (48 layers, d_model 1536, 48 heads × 64, state 128) or
    slice 9's zamba2-2.7b (54 such layers at d_model 2560, 80 heads × 64,
    state 64, and one shared attention block after every 9, each
    application on a ring KV cache of prompt + gen rows): random weights,
    seed 0, ``repro_torch.launch.serve.serve`` at ``SSM_RUNS[arch]``'s
    shape and (weight, KV) bits, the ``ssd_chunk_scan`` and ``qmm``
    counters set to 0 just before and read just after each call: one SSD
    launch a layer (one prefill), every one on the tensor cores, and at int
    weights ``qmm`` 2 a layer plus 7 a shared-block application per prefill
    and per decode step, none at bf16; its tokens/s gives the decode step
    time. Then, on the same weights through ``T.prefill_state`` and the
    serve step (counters again): prefill(prompt), timed (the prefill time),
    against prefill(prompt[:, :-1]) + one decode step, reported; the
    serving peak memory; a profile of one prefill as serve() runs it (SSD's
    and ``qmm``'s device ms in it, its peak memory) and, from its state, of
    5 decode steps after one (``HYBRID_PROFILE_STEPS`` for the hybrid; their
    peak too); that state's cache bytes
    (the Mamba2 caches and the shared KV caches apart). Then
    the same consistency at f32 (f32 weights, seed 0), gated at the run's
    tolerance of the largest |logit|. Only the serve() calls' launches are
    the main path's (the kernels line); the checks' are reported apart.
    Every shape either kernel launched on any of these runs must be among
    the checked ones."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs, prng
    from repro_torch.kernels import qmm as Q
    from repro_torch.kernels import ssd as SD
    from repro_torch.launch import serve as S
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.quant import tree_nbytes

    tag, width, shape, bits_runs, tol = SSM_RUNS[arch]
    bsz, plen, gen = shape["batch"], shape["prompt_len"], shape["gen"]
    # launches by shape: the main path's (the serve() calls) and the
    # checks' (the consistency prefills and steps, and at f32) apart
    path = {"ssd_chunk_scan": collections.Counter(), "qmm": collections.Counter()}
    checks = {"ssd_chunk_scan": collections.Counter(), "qmm": collections.Counter()}

    def reset():
        Q.reset_counters()
        SD.launches = SD.tc_launches = 0
        SD.shape_launches.clear()

    def read(into):
        _core_gate(tag, Q)
        into["ssd_chunk_scan"].update(SD.shape_launches)
        into["qmm"].update(Q.shape_launches)
        return {"ssd_chunk_scan": SD.launches, "qmm": Q.launches}

    def prompts_for(cfg):
        return prng.randint(prng.fold_in(prng.PRNGKey(0), 1), (bsz, plen), 0,
                            cfg.vocab_size, device=dev)

    hybrid = arch != "mamba2-780m"
    out = {}
    for wbits, kvbits in bits_runs:
        label = f"{wbits or 'bf16'}/{kvbits or 'bf16'}" if hybrid else f"{wbits or 'bf16'}"
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        tokens, tps = S.serve(arch, reduced=False, weight_bits=wbits, kv_bits=kvbits,
                              device=dev, **shape)
        wall = time.perf_counter() - t0
        if SD.tc_launches != SD.launches:
            raise AssertionError(f"{tag} bits {label}: {SD.launches - SD.tc_launches} "
                                 f"of {SD.launches} SSD launches off the tensor cores")
        launches = read(path)
        call_peak = torch.cuda.max_memory_allocated() - base
        plan = S._resolve_plan(None, kvbits, wbits)
        cfg, params = S._build(arch, reduced=False, plan=plan, seed=0, device=dev)
        L = cfg.n_layers
        if _ssm_width(cfg) != width:
            raise AssertionError(f"not full-width {arch}: {cfg}")
        if tokens.shape != (bsz, plen + gen) or tokens.min() < 0 \
                or tokens.max() >= cfg.vocab_size:
            raise AssertionError(f"{tag} tokens {tokens.shape}, range "
                                 f"{tokens.min()}..{tokens.max()}")
        # in/out projections a Mamba2 layer, q/k/v/o/gate/up/down a shared block
        per_pass = 2 * L + 7 * (L // cfg.shared_attn_every if hybrid else 0) if wbits else 0
        want = {"ssd_chunk_scan": L, "qmm": per_pass * (1 + gen)}
        if launches != want:
            raise AssertionError(f"{tag} bits {label}: launches {launches}, "
                                 f"expected {want}")
        # the same weights and prompts through the entry points serve() calls
        prompts = prompts_for(cfg)
        if not np.array_equal(prompts.cpu().numpy(), tokens[:, :plen]):
            raise AssertionError(f"{tag} the rebuilt prompts differ from serve()'s")
        step = make_serve_step(cfg)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset()
        cons, _, _, prefill_s = _consistency(T, step, params, prompts, cfg, tag)
        cons_launches = read(checks)
        serving_peak = torch.cuda.max_memory_allocated() - base
        if cons_launches != {"ssd_chunk_scan": 2 * L, "qmm": 3 * per_pass}:
            raise AssertionError(f"{tag} consistency launches {cons_launches}")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logits, state = T.prefill_state(params, prompts, cfg, pad_to=plen + gen)
            torch.cuda.synchronize()
            pre_wall_ms = 1e3 * (time.perf_counter() - t0)
        prefill_peak = torch.cuda.max_memory_allocated() - base
        by_kernel, _ = _device_kernels(prof)
        pre_dev = sum(by_kernel.values())
        pre_ssd = sum(v for k, v in by_kernel.items() if "ssd_" in k)
        pre_qmm = sum(v for k, v in by_kernel.items() if "qmm_" in k or "splitk_reduce" in k)
        pre_top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6])
        print(f"[profile] one prefill ({bsz} x {plen}): wall {pre_wall_ms:.1f} ms, device "
              f"busy {pre_dev:.1f} ms, ssd_chunk_scan {pre_ssd:.2f} ms and qmm {pre_qmm:.2f} "
              f"ms of it; peak {prefill_peak / 2**30:.2f} GiB; top: " + "; ".join(
                  f"{k[:40]} {v:.2f}" for k, v in pre_top.items()), flush=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
        prof_decode = profile_steps(step, params, state, nxt,
                                    HYBRID_PROFILE_STEPS if hybrid else 5)
        decode_peak = torch.cuda.max_memory_allocated() - base
        cache = {"layers": tree_nbytes(state.layers._asdict()) // bsz,
                 "shared": (tree_nbytes({k: v for k, v in state.shared._asdict().items()
                                         if v is not None}) // bsz
                            if state.shared is not None else 0)}
        # serve() times its gen − 1 steady decode steps of the whole batch
        run = {"weight_bits": wbits, "kv_bits": kvbits, "tokens_shape": list(tokens.shape),
               "prefill_ms": 1e3 * prefill_s,
               "decode_ms_per_step": 1e3 * bsz / tps,
               "decode_tokens_per_s": tps, "serve_call_peak_bytes": call_peak,
               "serving_peak_bytes": serving_peak, "prefill_peak_bytes": prefill_peak,
               "decode_peak_bytes": decode_peak,
               "cache_bytes_per_sequence": cache["layers"] + cache["shared"],
               "mamba_cache_bytes_per_sequence": cache["layers"],
               "shared_kv_cache_bytes_per_sequence": cache["shared"],
               "weight_bytes": tree_nbytes(params),
               "wall_s": wall, "launches": launches, "consistency_launches": cons_launches,
               "consistency": cons,
               "prefill_profile": {"wall_ms": pre_wall_ms, "device_ms": pre_dev,
                                   "ssd_ms": pre_ssd, "qmm_ms": pre_qmm,
                                   "top_kernels_ms": pre_top},
               "decode_profile": prof_decode}
        print(f"{tag} {arch} full width, weight{'/KV' if hybrid else ''} bits {label}: tokens "
              f"{tuple(tokens.shape)}; prefill {run['prefill_ms']:.1f} ms ({bsz} x {plen}; "
              f"profiled: wall {pre_wall_ms:.1f}, device {pre_dev:.1f}, ssd_chunk_scan "
              f"{pre_ssd:.2f}, qmm {pre_qmm:.2f}); "
              f"decode {run['decode_ms_per_step']:.2f} "
              f"ms/step, {tps:.1f} tok/s; peak {call_peak / 2**30:.2f} GiB over the serve() "
              f"call (weight init included), {serving_peak / 2**30:.2f} GiB serving "
              f"(prefill, prefill, step), {prefill_peak / 2**30:.2f} over one prefill, "
              f"{decode_peak / 2**30:.2f} over {prof_decode['steps'] + 1} decode steps; cache "
              f"{run['cache_bytes_per_sequence']:,} bytes/sequence (Mamba2 "
              f"{cache['layers']:,}, shared KV {cache['shared']:,}); weights "
              f"{run['weight_bytes']:,} bytes; launches {launches}; "
              f"prefill(p[:-1]) + decode vs prefill(p): max |dlogit| "
              f"{cons['max_abs']:.3e} of {cons['logit_scale']:.3g}, argmax equal "
              f"{cons['argmax_equal']}/{bsz} (reported, not gated)", flush=True)
        out[label if hybrid else wbits] = run
        del params, state
        torch.cuda.empty_cache()
    # the bookkeeping gate at f32, as the reference's test runs it
    cfg = configs.get_config(arch, dtype=torch.float32)
    params = T.init_params(cfg, seed=0, device=dev)
    reset()
    cons, full, last, _ = _consistency(T, make_serve_step(cfg), params,
                                       prompts_for(cfg), cfg, tag)
    cons["launches"] = read(checks)
    ok = cons["max_abs"] <= tol * cons["logit_scale"]
    print(f"{tag} f32 full width: prefill(p[:-1]) + decode vs prefill(p): max "
          f"|dlogit| {cons['max_abs']:.3e} of {cons['logit_scale']:.3g} (tol {tol:g} of "
          f"the largest), argmax equal {cons['argmax_equal']}/{bsz}; launches "
          f"{cons['launches']}", flush=True)
    if not ok or cons["launches"]["ssd_chunk_scan"] != 2 * cfg.n_layers:
        raise AssertionError(f"{tag} f32 consistency: {cons}")
    out["consistency_f32"] = cons
    del params, full, last
    checked = {"ssd_chunk_scan": {r["key"] for r in ssd_rows},
               "qmm": {r["key"] for r in qmm_rows}}
    for name in path:
        unchecked = (set(path[name]) | set(checks[name])) - checked[name]
        if unchecked:
            raise AssertionError(f"{tag} {name} launched at unchecked shapes "
                                 f"{sorted(unchecked)}")
    out["shape_launches"] = {name: [[*k, v] for k, v in c.items()] for name, c in path.items()}
    out["check_shape_launches"] = {name: [[*k, v] for k, v in c.items()]
                                   for name, c in checks.items()}
    torch.cuda.empty_cache()
    return out


def agree_mamba(dev):
    """Reduced mamba2-780m built in-process from one torch seed, chunk 16
    (a 64-token prompt is 4 chunks), on the card (``ssd_chunk_scan``,
    ``qmm``) against the CPU's plain path: prefill + 8 greedy decode steps;
    at f32 every logit within ``MAMBA_CHECK_TOL`` of the largest, at bf16
    the greedy tokens equal; weight bits 0 and 8. Both run the ``cuda``
    backend (on the CPU: the kernels' plain versions)."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.kernels import registry
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.precision.qat import quantize_param_tree

    out = {}
    for dname, bits in (("float32", 0), ("float32", 8), ("bfloat16", 0), ("bfloat16", 8)):
        cfg = dataclasses.replace(
            configs.get_reduced("mamba2-780m", dtype=getattr(torch, dname)), ssd_chunk=16)
        params = T.init_params(cfg, seed=0, device="cpu")
        if bits:
            params = quantize_param_tree(params, bits=bits)
        step = make_serve_step(cfg)
        prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 64)))
        res = {}
        for label, where in (("card", dev), ("cpu", "cpu")):
            p = _tree_to(params, where)
            with registry.using("cuda"):      # on the CPU: the kernels' plain versions
                logits, state = T.prefill(p, prompt.to(where), cfg)
                toks, lgs = [torch.argmax(logits, -1).to(torch.int32)[:, None]], [logits]
                for _ in range(8):
                    lg, nxt, state = step(p, state, toks[-1])
                    toks.append(nxt[:, None])
                    lgs.append(lg[:, 0])
            res[label] = (torch.cat(toks, 1).cpu(), [t.float().cpu() for t in lgs])
        (tc, lc), (tp, lp) = res["card"], res["cpu"]
        rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(lc, lp))
        same = bool(torch.equal(tc, tp))
        print(f"[check] reduced mamba2-780m {dname} weight bits {bits or 'bf16'}: card vs "
              f"CPU plain path — tokens equal {same}, logits max rel diff {rel:.2e}", flush=True)
        if (dname == "float32" and rel > MAMBA_CHECK_TOL) or (dname == "bfloat16" and not same):
            raise AssertionError(f"[check] reduced mamba2 {dname} bits {bits}: tokens equal "
                                 f"{same}, logits rel {rel}")
        out[f"{dname}_{bits}"] = {"tokens_equal": same, "logits_max_rel_diff": rel}
    return out


def agree_hybrid(dev):
    """Reduced zamba2-2.7b (4 layers, the shared block after every 2) built
    in-process from one torch seed, chunk 16 (a 64-token prompt is 4
    chunks), at ``HYBRID_CHECKS``' dtypes and weight/KV bits, on the card
    (``ssd_chunk_scan``, ``qmm``) against the CPU's plain path: prefill
    (shared caches of prompt + 9 rows) + 8 greedy decode steps, each side
    fed the CPU's greedy tokens; at f32 with raw KV rows every logit within
    ``HYBRID_CHECK_TOL`` of the largest, and everywhere the card's greedy
    token equal to the CPU's where the CPU's top two logits lie more than
    ``HYBRID_TIE`` of the largest apart. Both run the ``cuda`` backend (on
    the CPU: the kernels' plain versions)."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.kernels import registry
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.precision.qat import quantize_param_tree
    from repro_torch.quant import PrecisionPlan

    out = {}
    for dname, bits, kv_bits in HYBRID_CHECKS:
        plan = PrecisionPlan(model_bits=bits, kv_bits=kv_bits,
                             model_storage="int" if bits else "fake")
        cfg = dataclasses.replace(configs.get_reduced(
            "zamba2-2.7b", dtype=getattr(torch, dname), precision=plan), ssd_chunk=16)
        params = T.init_params(cfg, seed=0, device="cpu")
        if bits:
            params = quantize_param_tree(params, bits=bits)
        step = make_serve_step(cfg)
        prompt = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 64)))
        lgs, fed = {}, None
        for label, where in (("cpu", "cpu"), ("card", dev)):
            p = _tree_to(params, where)
            with registry.using("cuda"):  # on the CPU: the kernels' plain versions
                logits, state = make_prefill_step(cfg, pad_to=64 + 9)(
                    p, {"tokens": prompt.to(where)})
                out_ = [logits]
                for i in range(8):
                    tok = torch.argmax(out_[-1], -1) if fed is None else fed[i]
                    lg, _, state = step(p, state, tok.to(where, torch.int32)[:, None])
                    out_.append(lg[:, 0])
            lgs[label] = [t.float().cpu()[:, :cfg.vocab_size] for t in out_]
            fed = [torch.argmax(t, -1) for t in lgs["cpu"]]
        rel = tied = same = 0
        for a, b in zip(lgs["card"], lgs["cpu"]):
            scale = b.abs().max()
            rel = max(rel, float((a - b).abs().max() / scale))
            top2 = b.topk(2, -1).values
            clear = (top2[:, 0] - top2[:, 1]) > HYBRID_TIE[dname] * scale
            tied += int((~clear).sum())
            same += int(((a.argmax(-1) == b.argmax(-1)) | ~clear).sum())
        n = 4 * len(lgs["cpu"])
        gated = dname == "float32" and not kv_bits
        print(f"[check] reduced zamba2-2.7b {dname} weight/KV bits {bits or 'bf16'}/"
              f"{kv_bits or 'raw'}: card vs CPU plain path, fed the CPU's tokens — greedy "
              f"tokens equal {same}/{n} ({tied} within {HYBRID_TIE[dname]:g} of a tie), logits max "
              f"rel diff {rel:.2e} ({'tol %g' % HYBRID_CHECK_TOL if gated else 'reported'})",
              flush=True)
        if same != n or (gated and rel > HYBRID_CHECK_TOL):
            raise AssertionError(f"[check hybrid] reduced zamba2 {dname} bits "
                                 f"{bits}/{kv_bits}: tokens equal {same}/{n}, logits rel {rel}")
        out[f"{dname}_{bits}_{kv_bits}"] = {"tokens_equal": same, "near_ties": tied,
                                            "logits_max_rel_diff": rel}
    return out


def serve_dense(dev, checked):
    """Slice 8's main path: ``serve_engine`` on full-width gemma-7b,
    granite-3-8b and qwen2.5-14b (random weights, seed 0) on the slice-1
    trace at ``DENSE_RUNS``' bits, with every gate of ``[serve]`` (via
    :func:`serve`): full width, 8 of 8 requests finished, no page leaked,
    tokens in the vocab, ``qmm`` 7 × L × (decode steps + admitted) launches
    at checked shapes on plan's core, ``paged_decode_attn`` L × decode
    steps; each run's peak memory and a decode profile."""
    return {f"{arch} {bits}/{bits}": serve(bits, dev, checked, arch, "serve-dense",
                                           profile_steps=DENSE_PROFILE_STEPS,
                                           max_new=DEPTH_MAX_NEW)
            for arch, bits in DENSE_RUNS}


def serve_legacy_dense(dev, checked):
    """The legacy loop on a dense model: ``launch.serve.serve`` on full-width
    qwen2.5-14b at ``LEGACY_DENSE`` (ring KV cache of prompt + gen rows),
    the ``qmm`` and ``paged_decode_attn`` counters set to 0 just before and
    read just after: ``qmm`` 7 × L per prefill and per decode step (the
    warm-up step included) at checked shapes, ``paged_decode_attn`` 0 (the
    ring path attends in plain PyTorch, as the reference). Then, on the same
    weights rebuilt from the seed, the ring path's prefill (``T.prefill_state``,
    what serve() ran) against the paged engine's (``T.prefill`` at kv 0) on
    the same prompts — one forward, so the logits must be bit-equal — and
    against serve()'s first generated tokens; a profile of 5 decode steps."""
    import dataclasses

    import torch
    from repro_torch import prng
    from repro_torch.kernels import paged_attn as PA
    from repro_torch.kernels import qmm as Q
    from repro_torch.launch import serve as S
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.quant import tree_nbytes

    kw = dict(LEGACY_DENSE)
    arch = kw.pop("arch")
    bsz, plen, gen = kw["batch"], kw["prompt_len"], kw["gen"]
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    Q.reset_counters()
    PA.launches = 0
    t0 = time.perf_counter()
    tokens, tps = S.serve(arch, reduced=False, device=dev, **kw)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = {"qmm": Q.launches, "paged_decode_attn": PA.launches}
    cores = _core_gate(f"[serve-legacy-dense] {arch}", Q, checked)
    shapes = dict(Q.shape_launches)
    plan = S._resolve_plan(None, kw["kv_bits"], kw["weight_bits"])
    cfg, params = S._build(arch, reduced=False, plan=plan, seed=0, device=dev)
    L = cfg.n_layers
    if _width(cfg) != DENSE_WIDTH[arch]:
        raise AssertionError(f"not full-width {arch}: {cfg}")
    if tokens.shape != (bsz, plen + gen) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab_size:
        raise AssertionError(f"[serve-legacy-dense] tokens {tokens.shape}, range "
                             f"{tokens.min()}..{tokens.max()}")
    want = {"qmm": 7 * L * (gen + 1), "paged_decode_attn": 0}
    if launches != want:
        raise AssertionError(f"[serve-legacy-dense] launches {launches}, expected {want}")
    prompts = prng.randint(prng.fold_in(prng.PRNGKey(0), 1), (bsz, plen), 0,
                           cfg.vocab_size, device=dev)
    if not np.array_equal(prompts.cpu().numpy(), tokens[:, :plen]):
        raise AssertionError("[serve-legacy-dense] the rebuilt prompts differ from serve()'s")
    Q.reset_counters()
    ring, state = make_prefill_step(cfg, pad_to=plen + gen)(params, {"tokens": prompts})
    engine_cfg = dataclasses.replace(cfg, precision=dataclasses.replace(plan, kv_bits=0))
    paged, _ = T.prefill(params, prompts, engine_cfg)
    same = bool(torch.equal(ring, paged))
    first = torch.argmax(ring, -1).cpu().numpy()
    if not same or not np.array_equal(first, tokens[:, plen]):
        raise AssertionError(f"[serve-legacy-dense] ring prefill logits bit-equal to the "
                             f"engine's: {same}; first tokens {first} vs serve()'s "
                             f"{tokens[:, plen]}")
    step = make_serve_step(cfg)
    prof = profile_steps(step, params, state, torch.as_tensor(first, device=dev)
                         .to(torch.int32)[:, None])
    _core_gate("[serve-legacy-dense] checks", Q, checked)
    run = {"arch": arch, **kw, "tokens_shape": list(tokens.shape),
           "decode_ms_per_step": 1e3 * bsz / tps, "decode_tokens_per_s": tps,
           "peak_bytes": peak, "wall_s": wall, "launches": launches,
           "qmm_launches_by_core": cores,
           "qmm_shape_launches": [[*k, v] for k, v in shapes.items()],
           "cache_bytes_per_sequence": tree_nbytes(state.layers._asdict()) // bsz,
           "weight_bytes": tree_nbytes(params), "prefill_logits_bit_equal": same,
           "decode_profile": prof}
    print(f"[serve-legacy-dense] {arch} full width, weight/kv bits {kw['weight_bits']}/"
          f"{kw['kv_bits']}: tokens {tuple(tokens.shape)} in vocab; decode "
          f"{run['decode_ms_per_step']:.2f} ms/step, {tps:.1f} tok/s; peak "
          f"{peak / 2**30:.2f} GiB over the serve() call; ring cache "
          f"{run['cache_bytes_per_sequence']:,} bytes/sequence; launches {launches} "
          f"{cores}; ring prefill logits bit-equal to the engine's prefill: {same}",
          flush=True)
    del params, state
    torch.cuda.empty_cache()
    return run


def _biased(tree, seed: int = DENSE_BIAS_SEED):
    """``tree`` with every bias leaf ``b`` drawn N(0, 0.25) from a numpy seed
    (the init's zeros would hide a bias never added)."""
    import torch

    rng = np.random.default_rng(seed)

    def go(node):
        if not isinstance(node, dict):
            return node
        return {k: torch.from_numpy(rng.normal(0, 0.5, tuple(v.shape)).astype(np.float32))
                .to(v.dtype) if k == "b" else go(v) for k, v in sorted(node.items())}
    return go(tree)


def agree_dense(dev):
    """Slice 8's reduced models at f32 (qwen2.5-14b with nonzero q/k/v
    biases) at weight/KV bits 8 and 4, on the card (kernels) against the
    CPU's plain path from the same weights: the paged engine's first
    generated token of every request must agree, and the legacy loop's
    greedy tokens (ring cache, prefill + 8 decode steps) must be equal."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import registry
    from repro_torch.launch.serve import make_trace
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.precision.qat import quantize_param_tree
    from repro_torch.quant import PrecisionPlan
    from repro_torch.serve import ServeEngine

    out = {}
    for arch in DENSE_ARCHS:
        for bits in (8, 4):
            plan = PrecisionPlan(model_bits=bits, kv_bits=bits, model_storage="int")
            cfg = configs.get_reduced(arch, dtype=torch.float32, precision=plan)
            params = quantize_param_tree(_biased(T.init_params(cfg, seed=0, device="cpu")),
                                         bits=bits)
            prompt = torch.from_numpy(np.random.default_rng(1).integers(
                0, cfg.vocab_size, (4, 24)))
            res, legacy = {}, {}
            for where in (dev, "cpu"):
                eng = ServeEngine(params, cfg, max_slots=4, page_size=8, max_seq_len=56,
                                  backend="cuda", device=where)
                res[str(where)] = eng.run(make_trace(8, cfg.vocab_size, max_new=16,
                                                     max_prompt=32, seed=0))
                p = _tree_to(params, where)
                with registry.using("cuda"):      # on the CPU: the kernels' plain versions
                    logits, state = make_prefill_step(cfg, pad_to=33)(
                        p, {"tokens": prompt.to(where)})
                    toks = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
                    step = make_serve_step(cfg)
                    for _ in range(8):
                        _, nxt, state = step(p, state, toks[-1])
                        toks.append(nxt[:, None])
                legacy[str(where)] = torch.cat(toks, 1).cpu()
            on_card, on_cpu = res[str(dev)], res["cpu"]
            first = sum(int(on_card[r].tokens[on_card[r].prompt_len]
                            == on_cpu[r].tokens[on_cpu[r].prompt_len]) for r in on_cpu)
            same = sum(int((on_card[r].tokens == on_cpu[r].tokens).all()) for r in on_cpu)
            legacy_same = bool(torch.equal(legacy[str(dev)], legacy["cpu"]))
            print(f"[check] reduced {arch} f32 int{bits}: card kernels vs CPU plain path — "
                  f"engine first tokens equal {first}/8, whole sequences equal {same}/8; "
                  f"legacy loop tokens equal {legacy_same}", flush=True)
            if first != 8 or not legacy_same:
                raise AssertionError(f"[check dense] reduced {arch} int{bits}: first tokens "
                                     f"{first}/8, legacy tokens equal {legacy_same}")
            out[f"{arch} {bits}"] = {"first_tokens_equal": first, "sequences_equal": same,
                                     "legacy_tokens_equal": legacy_same}
    return out


def check_qmm_moe(dev, flush):
    """B5 at every (K, N) of granite-moe-3b-a800m (``MOE_QMM_KN``: the
    router's N 40 — int8 rows of 40 bytes, packed int4 rows of 20 — among
    them), int8 and int4, at decode M 4 (SIMT), each prompt bucket of the
    trace [serve-moe] serves and its decode profile's 64 (tensor cores),
    the dispatch's capacity (1024: the experts of the legacy prefill) and
    the legacy prefill's 4096 (q, k, v, o and the router)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(14)
    ms = {SERVE["max_slots"]: "decode", 64: "profile prefill"}
    for m in sorted(_prompt_buckets(MOE)):
        ms[m] = f"prefill, bucket {m}"
    ms[MOE_CAPACITY] = "dispatch capacity"
    ms[MOE_LEGACY["batch"] * MOE_LEGACY["prompt_len"]] = "legacy prefill"
    rows = []
    for bits in (8, 4):
        for (k, n), what in MOE_QMM_KN.items():
            for m, role in sorted(ms.items()):
                rows.append(_qmm_row(dev, gen, flush, bits, m, k, n,
                                     f" (granite-moe {what}; {role})"))
    return rows


@contextlib.contextmanager
def _routing(log, local=None):
    """Every ``moe._router_probs`` call inside appends (top-k ids,
    probabilities) to ``log`` on the host: the routing, captured by wrapping
    the function here, with no hook in the package. Given a list ``local``,
    each call also appends there what the ``ref`` backend's router gives on
    the same input (the routing compared layer by layer, where the two
    backends see the same x)."""
    from repro_torch.kernels import registry
    from repro_torch.models import moe

    orig = moe._router_probs

    def wrapped(p, x, spec):
        out = orig(p, x, spec)
        log.append((out[1].cpu(), out[2].float().cpu()))
        if local is not None:
            with registry.using("ref"):
                ref = orig(p, x, spec)
            local.append((ref[1].cpu(), ref[2].float().cpu()))
        return out

    moe._router_probs = wrapped
    try:
        yield log
    finally:
        moe._router_probs = orig


def _routing_diffs(got, want, k) -> tuple[int, float]:
    """(routing choices that differ, the largest gap between ``want``'s k-th
    and (k+1)-th probability at a token whose choices differ) over matched
    router calls."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} router calls against {len(want)}")
    n, worst = 0, 0.0
    for (ia, _), (ib, pb) in zip(got, want):
        sa, sb = ia.sort(-1).values, ib.sort(-1).values
        bad = (sa != sb).any(-1)
        if bad.any():
            n += int((sa != sb).sum())
            top = pb.sort(-1, descending=True).values
            worst = max(worst, float((top[..., k - 1] - top[..., k])[bad].max()))
    return n, worst


def _engine_forced(eng, prompts: np.ndarray, steps: int, fed=None):
    """Logits of one engine's own prefill (``_prefill``) and ``steps``
    decode steps (``decode_logits``) of ``prompts`` (one a slot, lengths a
    page multiple), each step fed ``fed[t]`` (default its own greedy
    tokens); the pages go back to the allocator after."""
    import torch
    from repro_torch.serve import pages as pg

    n, s = prompts.shape
    need = pg.pages_needed(s + steps + 1, eng.page_size)
    bt = np.zeros((eng.max_slots, eng.max_pages_per_seq), np.int32)
    ids = []
    for i in range(n):
        got = eng.allocator.alloc(need)
        ids.append(got)
        bt[i, :need] = got
    out = [torch.stack([eng._prefill(prompts[i], s - 1, list(bt[i, :s // eng.page_size]))
                        for i in range(n)])]
    active = np.arange(eng.max_slots) < n
    for t in range(steps):
        tok = np.zeros(eng.max_slots, np.int32)
        tok[:n] = (out[-1].argmax(-1).cpu().numpy() if fed is None else fed[t])
        pos = np.where(active, s + t, 0).astype(np.int32)
        out.append(eng.decode_logits(tok, pos, bt, active)[:n])
    for got in ids:
        eng.allocator.free(got)
    return [t.float().cpu() for t in out]


def _routed(glog, wlog, n: int, L: int, steps: int, per_prompt: bool) -> np.ndarray:
    """routed[b, t]: a routing choice of sequence b differed between the
    two router logs in the calls behind logits t, or before. Logits 0 come
    from the prefill — one forward of L calls of (n, S, k), or with
    ``per_prompt`` n forwards of (1, S, k) — logits t ≥ 1 from decode step
    t, L calls of (n, 1, k)."""
    routed = np.zeros((n, steps + 1), bool)
    pre = n * L if per_prompt else L
    for c, ((ia, _), (ib, _)) in enumerate(zip(glog, wlog)):
        rows = (ia.sort(-1).values != ib.sort(-1).values).reshape(ia.shape[0], -1).any(-1)
        if c < pre and per_prompt:
            routed[c // L, 0] |= bool(rows.any())
        else:
            routed[:, 0 if c < pre else 1 + (c - pre) // L] |= rows.numpy()[:n]
    return np.logical_or.accumulate(routed, axis=1)


def _fmt(x) -> str:
    return "none" if x is None else f"{x:.3e}"


def _forced_tokens(got, want, routed, tie: float) -> dict:
    """Greedy tokens of two teacher-forced runs (logits lists, both fed
    ``want``'s tokens): equal wherever ``want``'s top two logits lie more
    than ``tie`` of the largest apart and no routing choice of the sequence
    differed so far (``routed``); the counts, and the logits' largest gap
    over all and over the rows whose routing never differed (None where
    every row's did)."""
    rel, rel_same = 0.0, None
    tied = excused = same = 0
    for t, (a, b) in enumerate(zip(got, want)):
        scale = b.abs().max()
        gap = (a - b).abs().max(-1).values / scale
        rel = max(rel, float(gap.max()))
        if (~routed[:, t]).any():
            rel_same = max(rel_same or 0.0, float(gap[~routed[:, t]].max()))
        top2 = b.topk(2, -1).values
        clear = ((top2[:, 0] - top2[:, 1]) > tie * scale).numpy()
        eq = (a.argmax(-1) == b.argmax(-1)).numpy()
        tied += int((~clear).sum())
        excused += int((~eq & clear & routed[:, t]).sum())
        same += int((eq | ~clear | routed[:, t]).sum())
    return {"tokens_equal": same, "of": routed.size, "near_ties": tied,
            "excused_by_routing": excused, "logits_max_rel_diff": rel,
            "logits_max_rel_diff_same_routing": rel_same}


def _moe_forced(engine, dev):
    """[serve-moe]'s teacher-forced check on the served weights: the cuda
    backend (``qmm`` a slice, ``paged_decode_attn``) against the ref
    backend (each stacked weight decoded to bf16, one batched product;
    plain paged attention), each in an engine of its own on the card, both
    fed the ref backend's greedy tokens (``MOE_FORCED_STEPS`` steps after 4
    prefills of 64). The two differ at bf16, so a router's choices may
    differ where its k-th and (k+1)-th probabilities nearly tie: on the
    same input (the ref backend's router run on every input the cuda run's
    router saw) every such difference must lie within
    ``MOE_FORCED_ROUTE_TIE``. An expert swapped there moves the stream by
    far more than rounding, so a sequence's greedy token must equal the
    ref's wherever the ref's top two logits lie more than
    ``HYBRID_TIE["bfloat16"]`` of the largest apart and no routing choice
    of that sequence differed so far between the two runs. The tokens so
    excused, the routing differences (by layer) and the largest gaps are
    counted and reported."""
    import torch
    from repro_torch.launch.serve import make_trace
    from repro_torch.serve import ServeEngine

    t0 = time.perf_counter()
    cfg = engine.cfg
    prompts = np.stack([r.prompt for r in make_trace(4, cfg.vocab_size, min_prompt=64,
                                                     max_prompt=64, seed=11)]).astype(np.int32)
    n, L = len(prompts), cfg.n_layers
    runs, fed, local = {}, None, []
    for backend in ("ref", "cuda"):
        eng = ServeEngine(engine.params, cfg, max_slots=n, page_size=SERVE["page_size"],
                          max_seq_len=64 + MOE_FORCED_STEPS + SERVE["page_size"],
                          backend=backend, device=dev)
        with _routing([], local if backend == "cuda" else None) as log:
            lgs = _engine_forced(eng, prompts, MOE_FORCED_STEPS, fed)
        runs[backend] = ([t[:, :cfg.vocab_size] for t in lgs], log)
        fed = [t.argmax(-1).numpy() for t in runs["ref"][0][:-1]]
        del eng
    (got, glog), (want, wlog) = runs["cuda"], runs["ref"]
    n_route, gap = _routing_diffs(glog, wlog, cfg.top_k)
    n_local, gap_local = _routing_diffs(glog, local, cfg.top_k)
    by_layer = [_routing_diffs(glog[i::L], wlog[i::L], cfg.top_k)[0] for i in range(L)]
    res = _forced_tokens(got, want, _routed(glog, wlog, n, L, MOE_FORCED_STEPS, True),
                         HYBRID_TIE["bfloat16"])
    res.update(routing_choices_apart=n_route,
               routing_choices=sum(t[0].numel() for t in wlog), routing_largest_gap=gap,
               routing_apart_by_layer=by_layer, local_routing_choices_apart=n_local,
               local_routing_largest_gap=gap_local, seconds=time.perf_counter() - t0)
    print(f"[serve-moe] cuda vs ref backend on the card, teacher-forced ({MOE_FORCED_STEPS} "
          f"steps after {n} prefills of 64): greedy tokens equal {res['tokens_equal']}/"
          f"{res['of']} ({res['near_ties']} within {HYBRID_TIE['bfloat16']:g} of a tie, "
          f"{res['excused_by_routing']} after a routing difference); logits max rel diff "
          f"{res['logits_max_rel_diff']:.3e} ({_fmt(res['logits_max_rel_diff_same_routing'])} "
          f"where the routing never differed); routing choices apart {n_route} of "
          f"{res['routing_choices']} (by layer: {by_layer}), largest ref gap between the "
          f"k-th and (k+1)-th probability there {gap:.3e}; on the same input, layer by "
          f"layer: {n_local} apart, largest ref gap {gap_local:.3e} (bound "
          f"{MOE_FORCED_ROUTE_TIE:g}); {res['seconds']:.1f} s", flush=True)
    if res["tokens_equal"] != res["of"] or gap_local >= MOE_FORCED_ROUTE_TIE:
        raise AssertionError(f"[serve-moe] cuda vs ref: {res}")
    return {"forced": res}


def serve_moe(dev, checked):
    """Slice 10's main path: ``serve_engine`` on full-width
    granite-moe-3b-a800m at weight/KV bits 8/8 and 4/4 on the slice-1
    trace with every gate of ``[serve]`` (via :func:`serve`; ``qmm``
    32 × (4 + 1 + 3 × 40) = 4000 launches a decode step and a prefill, one
    a projection, the router and each expert slice, at checked shapes;
    ``paged_decode_attn`` 32 a step), peak memory, weight code bytes and a
    profile of ``MOE_PROFILE_STEPS`` decode steps; at 8/8 then the
    teacher-forced cuda-vs-ref check
    (:func:`_moe_forced`)."""
    import torch

    out = {}
    for bits in MOE_BITS:
        forced = (lambda e: _moe_forced(e, dev)) if bits == MOE_BITS[0] else None
        launches, shapes, summary = serve(bits, dev, checked, MOE, "serve-moe",
                                          extra=forced, profile_steps=MOE_PROFILE_STEPS,
                                          max_new=DEPTH_MAX_NEW)
        st = summary
        prof = st["profile"]
        print(f"[serve-moe] {bits}/{bits}: decode {st['mean_decode_step_ms']:.2f} ms/step, "
              f"{st['decode_tokens_per_s']:.1f} tok/s; device "
              f"{prof['device_ms_per_step'] or float('nan'):.3f} ms/step, idle share "
              f"{prof['device_idle_share'] or float('nan'):.3f}, "
              f"{prof['device_events_per_step']:.0f} device events/step; qmm launches a "
              f"decode step {st['launches_per_decode_step']['qmm']}, paged_decode_attn "
              f"{launches['paged_decode_attn']}; peak {st['peak_bytes'] / 2**30:.2f} GiB; "
              f"weight bytes {st['weight_bytes'] / 1e9:.3f} GB; serve_engine call "
              f"{st['wall_s']:.1f} s", flush=True)
        if st["launches_per_decode_step"]["qmm"] != 4000:
            raise AssertionError(f"[serve-moe] {st['launches_per_decode_step']}")
        out[f"{bits}/{bits}"] = (launches, shapes, summary)
        torch.cuda.empty_cache()
    return out


def _drops_by_layer(log, n_layers, capacity, k):
    """The share of each layer's routing choices that the dispatch drops at
    ``capacity``, from the first ``n_layers`` router calls of ``log`` (one
    prefill forward)."""
    out = []
    for ids, probs in log[:n_layers]:
        counts = np.bincount(ids.reshape(-1).numpy(), minlength=probs.shape[-1])
        out.append(float(np.maximum(counts - capacity, 0).sum() / ids.numel()))
    return out


def serve_legacy_moe(dev, checked):
    """The legacy loop on the moe family: ``launch.serve.serve`` on
    full-width granite-moe-3b-a800m at ``MOE_LEGACY`` (4 prompts of 1024,
    ring KV cache of prompt + gen rows, int8 weights and KV), the ``qmm``
    and ``paged_decode_attn`` counters set to 0 just before and read just
    after: ``qmm`` 4000 per prefill and per decode step (the warm-up step
    included) at checked shapes — the prefill's experts at the dispatch's
    capacity (M 1024), which shows it took the dispatch — and
    ``paged_decode_attn`` 0. Then, on the same weights rebuilt from the
    seed, a profiled prefill (device ms, ``qmm``'s share; serve() warmed
    its kernels and allocator) with each layer's dropped-choice share at
    capacity, and ``MOE_PROFILE_STEPS`` profiled decode steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import prng
    from repro_torch.kernels import paged_attn as PA
    from repro_torch.kernels import qmm as Q
    from repro_torch.launch import serve as S
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.quant import tree_nbytes

    kw = dict(MOE_LEGACY)
    bsz, plen, gen = kw["batch"], kw["prompt_len"], kw["gen"]
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    Q.reset_counters()
    PA.launches = 0
    t0 = time.perf_counter()
    tokens, tps = S.serve(MOE, reduced=False, device=dev, **kw)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = {"qmm": Q.launches, "paged_decode_attn": PA.launches}
    cores = _core_gate(f"[serve-legacy-moe] {MOE}", Q, checked)
    shapes = dict(Q.shape_launches)
    plan = S._resolve_plan(None, kw["kv_bits"], kw["weight_bits"])
    t1 = time.perf_counter()
    cfg, params = S._build(MOE, reduced=False, plan=plan, seed=0, device=dev)
    build_s = time.perf_counter() - t1
    L, E = cfg.n_layers, cfg.n_experts
    if _width(cfg) != DENSE_WIDTH[MOE] or (E, cfg.top_k) != (40, 8):
        raise AssertionError(f"not full-width {MOE}: {cfg}")
    if tokens.shape != (bsz, plen + gen) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab_size:
        raise AssertionError(f"[serve-legacy-moe] tokens {tokens.shape}, range "
                             f"{tokens.min()}..{tokens.max()}")
    want = {"qmm": _qmm_per_layer(cfg) * L * (gen + 1), "paged_decode_attn": 0}
    if launches != want:
        raise AssertionError(f"[serve-legacy-moe] launches {launches}, expected {want}")
    dispatched = sum(c for (packed, m, k, n), c in shapes.items() if m == MOE_CAPACITY)
    if dispatched != 3 * E * L:
        raise AssertionError(f"[serve-legacy-moe] {dispatched} qmm launches at the "
                             f"dispatch's capacity M {MOE_CAPACITY}, expected {3 * E * L}")
    prompts = prng.randint(prng.fold_in(prng.PRNGKey(0), 1), (bsz, plen), 0,
                           cfg.vocab_size, device=dev)
    prefill = make_prefill_step(cfg, pad_to=plen + gen)
    t1 = time.perf_counter()
    with _routing([]) as log, \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, state = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel, n_events = _device_kernels(prof)
    device_ms = sum(by_kernel.values())
    qmm_ms = sum(v for k_, v in by_kernel.items() if "qmm" in k_)
    drops = _drops_by_layer(log, L, MOE_CAPACITY, cfg.top_k)
    first = torch.argmax(logits, -1).cpu().numpy()
    if not np.array_equal(first, tokens[:, plen]):
        raise AssertionError(f"[serve-legacy-moe] rebuilt prefill's tokens {first} vs "
                             f"serve()'s {tokens[:, plen]}")
    prof_dec = profile_steps(make_serve_step(cfg), params, state,
                             torch.as_tensor(first, device=dev).to(torch.int32)[:, None],
                             MOE_PROFILE_STEPS)
    profiles_s = time.perf_counter() - t1
    _core_gate("[serve-legacy-moe] checks", Q, checked)
    run = {"arch": MOE, **kw, "tokens_shape": list(tokens.shape),
           "decode_ms_per_step": 1e3 * bsz / tps, "decode_tokens_per_s": tps,
           "prefill_ms": prefill_ms, "prefill_device_ms": device_ms or None,
           "prefill_qmm_device_ms": qmm_ms or None, "prefill_device_events": n_events,
           "prefill_top_kernels_ms": dict(sorted(by_kernel.items(),
                                                 key=lambda kv: -kv[1])[:8]),
           "dropped_choice_share_by_layer": drops, "capacity": MOE_CAPACITY,
           "peak_bytes": peak, "wall_s": wall, "launches": launches,
           "qmm_launches_by_core": cores,
           "qmm_shape_launches": [[*k_, v] for k_, v in shapes.items()],
           "cache_bytes_per_sequence": tree_nbytes(state.layers._asdict()) // bsz,
           "weight_bytes": tree_nbytes(params), "decode_profile": prof_dec}
    share = f"{qmm_ms / device_ms:.3f}" if device_ms else "not measured"
    print(f"[serve-legacy-moe] {MOE} full width, weight/kv bits {kw['weight_bits']}/"
          f"{kw['kv_bits']}: tokens {tuple(tokens.shape)} in vocab; prefill {prefill_ms:.1f} ms, "
          f"device {device_ms:.2f} ms, qmm {qmm_ms:.2f} ms (share {share}); decode "
          f"{run['decode_ms_per_step']:.2f} ms/step, {tps:.1f} tok/s, idle share "
          f"{prof_dec['device_idle_share'] or float('nan'):.3f}; peak {peak / 2**30:.2f} GiB; "
          f"launches {launches} {cores} ({dispatched} at the dispatch's capacity "
          f"M {MOE_CAPACITY}); serve() {wall:.1f} s, weights rebuilt in {build_s:.1f} s, "
          f"profiles {profiles_s:.1f} s; dropped-choice share by layer "
          + ", ".join(f"{d:.4f}" for d in drops), flush=True)
    del params, state
    torch.cuda.empty_cache()
    return run


def agree_moe(dev):
    """The reduced granite-moe-3b-a800m (8 experts, top 4) at weight/KV
    bits ``MOE_CHECKS``, on the card (kernels) against the CPU's plain path
    from the same weights, both the ``cuda`` backend, the router's calls
    captured on both sides, each run fed the CPU's greedy tokens:

    * the paged engine (4 prompts of 24 through its own prefill and 8
      ``decode_logits`` steps): at f32, and at bf16 for raw KV (B10 takes
      raw KV pages in bf16 only);
    * the legacy loop at f32 on 2 × 384 prompts (768 tokens: the prefill's
      MoE layers take the dispatch) + 8 decode steps.

    Greedy tokens equal wherever the CPU's top two logits lie more than
    ``HYBRID_TIE`` of the largest apart and no routing choice of the
    sequence differed so far; every routing difference where the CPU's
    k-th and (k+1)-th probabilities lie within ``MOE_ROUTE_TIE``; the
    legacy loop's raw-KV logits within ``HYBRID_CHECK_TOL`` of the largest
    on every sequence whose routing never differed."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.kernels import registry
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.precision.qat import quantize_param_tree
    from repro_torch.quant import PrecisionPlan
    from repro_torch.serve import ServeEngine

    out = {}
    b, s = MOE_CHECK_PROMPT
    legacy_prompt = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (b, s)))
    engine_prompts = np.random.default_rng(2).integers(0, 256, (4, 24)).astype(np.int32)
    for bits, kv_bits in MOE_CHECKS:
        plan = PrecisionPlan(model_bits=bits, kv_bits=kv_bits,
                             model_storage="int" if bits else "fake")
        cfg = configs.get_reduced(MOE, dtype=torch.float32, precision=plan)
        ecfg = cfg if kv_bits else dataclasses.replace(cfg, dtype=torch.bfloat16)
        trees = {}
        for c in {cfg, ecfg}:
            p = T.init_params(c, seed=0, device="cpu")
            trees[c.dtype] = quantize_param_tree(p, bits=bits) if bits else p
        L, row = cfg.n_layers, {}
        for what in ("engine", "legacy"):
            lgs, logs, fed = {}, {}, None
            for label, where in (("cpu", "cpu"), ("card", dev)):
                with _routing([]) as log:
                    if what == "engine":
                        eng = ServeEngine(trees[ecfg.dtype], ecfg, max_slots=4, page_size=8,
                                          max_seq_len=48, backend="cuda", device=where)
                        got = _engine_forced(eng, engine_prompts, 8, fed)
                    else:
                        p = _tree_to(trees[cfg.dtype], where)
                        step = make_serve_step(cfg)
                        with registry.using("cuda"):      # CPU: the plain versions
                            logits, state = make_prefill_step(cfg, pad_to=s + 9)(
                                p, {"tokens": legacy_prompt.to(where)})
                            got = [logits]
                            for i in range(8):
                                tok = torch.argmax(got[-1], -1) if fed is None else fed[i]
                                lg, _, state = step(p, state,
                                                    tok.to(where, torch.int32)[:, None])
                                got.append(lg[:, 0])
                        got = [t.float().cpu() for t in got]
                lgs[label] = [t[:, :cfg.vocab_size] for t in got]
                logs[label] = log
                fed = [t.argmax(-1) for t in lgs["cpu"]]
                if what == "engine":
                    fed = [t.numpy() for t in fed]
            n_route, gap = _routing_diffs(logs["card"], logs["cpu"], cfg.top_k)
            n = len(lgs["cpu"][0])
            dname = "bfloat16" if what == "engine" and not kv_bits else "float32"
            res = _forced_tokens(lgs["card"], lgs["cpu"],
                                 _routed(logs["card"], logs["cpu"], n, L, 8, what == "engine"),
                                 HYBRID_TIE[dname])
            res.update(routing_choices_apart=n_route, routing_largest_gap=gap, dtype=dname)
            gated = what == "legacy" and not kv_bits
            print(f"[check] reduced {MOE} {dname} weight/KV bits {bits or 'raw'}/"
                  f"{kv_bits or 'raw'} {what}: card vs CPU plain path, fed the CPU's tokens — "
                  f"greedy tokens equal {res['tokens_equal']}/{res['of']} ({res['near_ties']} "
                  f"within {HYBRID_TIE[dname]:g} of a tie, {res['excused_by_routing']} after a "
                  f"routing difference); routing choices apart {n_route} (largest CPU gap "
                  f"there {gap:.3e}, bound {MOE_ROUTE_TIE:g}); logits max rel diff "
                  f"{res['logits_max_rel_diff']:.2e}, "
                  f"{_fmt(res['logits_max_rel_diff_same_routing'])} where the routing never "
                  f"differed ({'tol %g' % HYBRID_CHECK_TOL if gated else 'reported'})",
                  flush=True)
            if res["tokens_equal"] != res["of"] or gap >= MOE_ROUTE_TIE or \
                    (gated and (res["logits_max_rel_diff_same_routing"] or 0.0)
                     > HYBRID_CHECK_TOL):
                raise AssertionError(f"[check moe] bits {bits}/{kv_bits} {what}: {res}")
            row[what] = res
        out[f"{bits}_{kv_bits}"] = row
    return out


def check_qmm_mixtral(dev, flush):
    """B5 at every (K, N) of mixtral-8x7b (``MIXTRAL_QMM_KN``: the router's
    N 8 — int8 rows of 8 bytes, packed int4 rows of 4 — among them), int8
    and int4, at decode M 2 (SIMT) and at the prefill's M (tensor cores):
    16384 for q, k, v, o and the router, the dispatch's capacity 5120 for
    the experts."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(15)
    decode_m = MIXTRAL_LEGACY["batch"]
    rows = []
    for bits in (8, 4):
        for (k, n), (what, prefill_m) in MIXTRAL_QMM_KN.items():
            for m, role in ((decode_m, "decode"), (prefill_m, "prefill")):
                rows.append(_qmm_row(dev, gen, flush, bits, m, k, n,
                                     f" (mixtral {what}; {role})"))
    return rows


def _matrix_params(cfg) -> int:
    """Entries of every matmul weight of an moe model: q, k, v, o, the
    router and each expert's gate, up and down, in every layer."""
    d, q, kv = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return cfg.n_layers * (2 * d * q + 2 * d * kv + d * cfg.n_experts
                           + 3 * cfg.n_experts * d * cfg.d_ff)


def _clone_tree(tree):
    """A copy of a (view) param tree: a layer's blocks outlive the stack."""
    from repro_torch.quant import QTensor

    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.codes.clone(), tree.scale.clone(), tree.scheme)
    return tree.clone()


def _serve_mixtral_bits(dev, checked, bits: int):
    """One [serve-mixtral] run at weight/KV bits ``bits`` (see
    :func:`serve_mixtral`); returns (run, layers 0 and 31's attention
    blocks at 8 bits, else None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import prng
    from repro_torch.kernels import paged_attn as PA
    from repro_torch.kernels import qmm as Q
    from repro_torch.launch import serve as S
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.layers import layer_view
    from repro_torch.quant import tree_nbytes

    kw = dict(MIXTRAL_LEGACY, weight_bits=bits, kv_bits=bits)
    bsz, plen, gen = kw["batch"], kw["prompt_len"], kw["gen"]
    tag = f"[serve-mixtral] {bits}/{bits}"
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    Q.reset_counters()
    PA.launches = 0
    t0 = time.perf_counter()
    tokens, tps = S.serve(MIXTRAL, reduced=False, device=dev, **kw)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = {"qmm": Q.launches, "paged_decode_attn": PA.launches}
    cores = _core_gate(tag, Q, checked)
    shapes = dict(Q.shape_launches)
    torch.cuda.empty_cache()
    plan = S._resolve_plan(None, kw["kv_bits"], kw["weight_bits"])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cfg, params = S._build(MIXTRAL, reduced=False, plan=plan, seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    L, E = cfg.n_layers, cfg.n_experts
    print(f"{tag} build: {_matrix_params(cfg) / 1e9:.2f} B matmul weights drawn and "
          f"encoded a layer at a time in {build_s:.1f} s", flush=True)
    if _width(cfg) != DENSE_WIDTH[MIXTRAL] or (E, cfg.top_k, cfg.window) != \
            (8, 2, MIXTRAL_WINDOW):
        raise AssertionError(f"not full-width {MIXTRAL}: {cfg}")
    if tokens.shape != (bsz, plen + gen) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab_size:
        raise AssertionError(f"{tag} tokens {tokens.shape}, range "
                             f"{tokens.min()}..{tokens.max()}")
    per_pass = _qmm_per_layer(cfg) * L
    want = {"qmm": per_pass * (gen + 1), "paged_decode_attn": 0}
    if per_pass != 928 or launches != want:
        raise AssertionError(f"{tag} launches {launches}, expected {want}")
    dispatched = sum(c for (packed, m, k, n), c in shapes.items() if m == MIXTRAL_CAPACITY)
    if dispatched != 3 * E * L:
        raise AssertionError(f"{tag} {dispatched} qmm launches at the dispatch's capacity "
                             f"M {MIXTRAL_CAPACITY}, expected {3 * E * L}")
    code_bytes, weight_bytes = _code_bytes(params), tree_nbytes(params)
    if code_bytes != _matrix_params(cfg) * bits // 8 or peak >= 80e9:
        raise AssertionError(f"{tag} code bytes {code_bytes} (expected "
                             f"{_matrix_params(cfg) * bits // 8}), peak {peak}")
    prompts = prng.randint(prng.fold_in(prng.PRNGKey(0), 1), (bsz, plen), 0,
                           cfg.vocab_size, device=dev)
    if not np.array_equal(prompts.cpu().numpy(), tokens[:, :plen]):
        raise AssertionError(f"{tag} the rebuilt prompts differ from serve()'s")
    prefill = make_prefill_step(cfg, pad_to=plen + gen)
    t1 = time.perf_counter()
    with _routing([]) as log, \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, state = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel, n_events = _device_kernels(prof)
    device_ms = sum(by_kernel.values())
    qmm_ms = sum(v for k_, v in by_kernel.items() if "qmm" in k_)
    drops = _drops_by_layer(log, L, MIXTRAL_CAPACITY, cfg.top_k)
    first = torch.argmax(logits, -1).cpu().numpy()
    if not np.array_equal(first, tokens[:, plen]):
        raise AssertionError(f"{tag} rebuilt prefill's tokens {first} vs serve()'s "
                             f"{tokens[:, plen]}")
    if not device_ms or not 0 < qmm_ms <= device_ms or max(drops) > MIXTRAL_DROP_MAX:
        raise AssertionError(f"{tag} prefill device {device_ms} ms, qmm {qmm_ms} ms, "
                             f"drops {drops}")
    # the ring: the window's rows a layer, the prompt's last W in order;
    # the first decode step writes slot 8192 % 4096 = 0 (position 4096)
    ring = state.layers
    rows = ring.k.shape[2]
    if rows != MIXTRAL_WINDOW or ring.length.unique().tolist() != [plen]:
        raise AssertionError(f"{tag} ring of {rows} rows, lengths "
                             f"{ring.length.unique().tolist()}")
    step = make_serve_step(cfg)
    tok = torch.as_tensor(first, device=dev).to(torch.int32)[:, None]
    Q.reset_counters()
    _, _, new = step(params, state, tok)
    step_qmm = Q.launches
    changed = (new.layers.k != ring.k).flatten(3).any(-1)          # (L, B, rows)
    written = [int(i) for i in changed.any(0).any(0).nonzero().flatten()]
    if written != [plen % rows] or not changed[:, :, plen % rows].all() \
            or step_qmm != per_pass:
        raise AssertionError(f"{tag} the first decode step wrote slots {written} "
                             f"(expected [{plen % rows}]) with {step_qmm} qmm launches")
    del new, changed
    prof_dec = profile_steps(step, params, state, tok, MOE_PROFILE_STEPS)
    if not prof_dec["device_ms_per_step"]:
        raise AssertionError(f"{tag} the decode profile read no device time")
    profiles_s = time.perf_counter() - t1
    _core_gate(f"{tag} checks", Q, checked)
    blocks = None
    if bits == 8:
        blocks = {i: _clone_tree(layer_view(params["layers"], i)["attn"])
                  for i in WINDOW_CHECK_LAYERS}
    run = {"arch": MIXTRAL, **kw, "tokens_shape": list(tokens.shape),
           "decode_ms_per_step": 1e3 * bsz / tps, "decode_tokens_per_s": tps,
           "prefill_ms": prefill_ms, "prefill_device_ms": device_ms,
           "prefill_qmm_device_ms": qmm_ms, "prefill_device_events": n_events,
           "prefill_top_kernels_ms": dict(sorted(by_kernel.items(),
                                                 key=lambda kv: -kv[1])[:8]),
           "dropped_choice_share_by_layer": drops, "capacity": MIXTRAL_CAPACITY,
           "peak_bytes": peak, "wall_s": wall, "build_s": build_s, "launches": launches,
           "qmm_launches_per_decode_step": step_qmm, "qmm_launches_by_core": cores,
           "qmm_shape_launches": [[*k_, v] for k_, v in shapes.items()],
           "ring_rows": rows, "first_step_slots": written,
           "cache_bytes_per_sequence": tree_nbytes(ring._asdict()) // bsz,
           "code_bytes": code_bytes, "weight_bytes": weight_bytes,
           "decode_profile": prof_dec}
    print(f"{tag}: {MIXTRAL} full width, tokens {tuple(tokens.shape)} in vocab; peak "
          f"{peak / 2**30:.2f} GiB over the serve() call; weights {weight_bytes / 1e9:.3f} GB "
          f"(codes {code_bytes / 1e9:.3f}); prefill {prefill_ms:.1f} ms, device "
          f"{device_ms:.2f} ms, qmm {qmm_ms:.2f} ms (share {qmm_ms / device_ms:.3f}); "
          f"capacity {MIXTRAL_CAPACITY}, {dispatched} launches there; dropped-choice share "
          f"by layer " + ", ".join(f"{d:.4f}" for d in drops) + f"; ring {rows} rows a "
          f"layer, first step wrote slot {written}; qmm {step_qmm} a decode step; decode "
          f"{run['decode_ms_per_step']:.2f} ms/step ({tps:.2f} tok/s), device "
          f"{prof_dec['device_ms_per_step']:.2f} ms, idle share "
          f"{prof_dec['device_idle_share']:.3f}, profiled wall "
          f"{prof_dec['wall_ms_per_step']:.1f} ms; launches {launches} {cores}; serve() "
          f"{wall:.1f} s, profiles {profiles_s:.1f} s", flush=True)
    del params, state, ring
    torch.cuda.empty_cache()
    return run, blocks


def serve_mixtral(dev, checked):
    """Slice 11's main path: ``launch.serve.serve`` (the legacy loop) on
    full-width mixtral-8x7b at ``MIXTRAL_LEGACY``, weight/KV bits 8/8 and
    4/4, the ``qmm`` and ``paged_decode_attn`` counters set to 0 just before
    and read just after each call: ``qmm`` 928 a prefill and a decode step
    (the warm-up step included) at checked shapes, the prefill's experts
    at the dispatch's capacity M 5120, ``paged_decode_attn`` 0 (the legacy
    loop attends in plain PyTorch, as the reference); in-vocab tokens; peak
    memory under 80 GB; the codes' bytes those of every matrix at the
    bits. Then, on the same weights rebuilt from the seed (timed: the
    build), a profiled prefill (device ms, ``qmm``'s share, each layer's
    dropped-choice share at capacity), the ring (W rows a layer; the first
    step writes slot 0 alone, with 928 ``qmm`` launches) and a profiled
    decode step. Returns ({bits: run}, layers 0 and 31's attention blocks
    of the int8 build for [check window])."""
    import torch

    out, blocks = {}, None
    for bits in MIXTRAL_BITS:
        out[f"{bits}/{bits}"], got = _serve_mixtral_bits(dev, checked, bits)
        blocks = blocks or got
        torch.cuda.empty_cache()
    return out, blocks


def check_window(dev, blocks):
    """The ring decode against the windowed prefill at full width: for
    layers 0 and 31's attention blocks of the int8 build, on 8193 random
    f32 rows, ring prefill of the first 8192 (``prefill_cache_from_kv``
    keeps the last W) plus ``attention_decode_step`` of row 8192 against
    the windowed ``attention_block``'s last row of all 8193 — within
    ``WINDOW_CHECK_TOL`` of its largest |output| at raw KV — and against the
    unwindowed block's (window 0), which must lie ``WINDOW_BINDS`` times
    that away. At int8 KV the gap is reported."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.models import attention as A

    spec = configs.get_config(MIXTRAL).attn_spec
    full_spec = dataclasses.replace(spec, window=0)
    s = MIXTRAL_LEGACY["prompt_len"]
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(1, s + 1, spec.n_heads * spec.head_dim, generator=gen, device=dev)
    out = {}
    with torch.no_grad():
        for layer, p in blocks.items():
            want = A.attention_block(p, x, spec)[:, -1:]
            unwindowed = A.attention_block(p, x, full_spec)[:, -1:]
            _, (k, v) = A.attention_block(p, x[:, :s], spec, return_kv=True)
            row = {}
            for kv_bits in (0, 8):
                cache = A.prefill_cache_from_kv(k, v, window=spec.window, kv_bits=kv_bits)
                got, new = A.attention_decode_step(p, x[:, s:], cache, spec)
                scale = float(want.abs().max())
                row[kv_bits] = {
                    "gap": float((got - want).abs().max()) / scale,
                    "gap_unwindowed": float((got - unwindowed).abs().max())
                    / float(unwindowed.abs().max()),
                    "ring_rows": cache.k.shape[1], "length": int(new.length[0])}
            out[layer] = row
            raw, q8 = row[0], row[8]
            print(f"[check window] {MIXTRAL} layer {layer}, f32, W {spec.window}: ring "
                  f"prefill of {s} + decode at position {s} against the windowed block's "
                  f"last row: gap {raw['gap']:.3e} of the largest (tol "
                  f"{WINDOW_CHECK_TOL:g}); against the unwindowed block's "
                  f"{raw['gap_unwindowed']:.3e} (at least {WINDOW_BINDS} x tol); int8 KV: "
                  f"{q8['gap']:.3e} (reported), unwindowed {q8['gap_unwindowed']:.3e}",
                  flush=True)
            if raw["ring_rows"] != spec.window or raw["length"] != s + 1 \
                    or not raw["gap"] <= WINDOW_CHECK_TOL \
                    or not raw["gap_unwindowed"] >= WINDOW_BINDS * WINDOW_CHECK_TOL:
                raise AssertionError(f"[check window] layer {layer}: {row}")
    return out


def agree_mixtral(dev):
    """The reduced mixtral-8x7b (4 experts, top 2, window 32) at weight/KV
    bits ``MIXTRAL_CHECKS``, f32, through the legacy loop on 2 prompts of
    each of ``MIXTRAL_CHECK_PROMPTS`` (64: the ring in its identity order;
    40: C24's, whose ring is out of order) + 8 decode steps, on the card
    (kernels) against the CPU's plain path from the same weights, both the
    ``cuda`` backend, each fed the CPU's greedy tokens, the routing
    captured on both sides: greedy tokens equal wherever the CPU's top two
    logits lie more than ``HYBRID_TIE`` of the largest apart and no routing
    choice of the sequence differed so far; every routing difference where
    the CPU's k-th and (k+1)-th probabilities lie within ``MOE_ROUTE_TIE``;
    raw-KV logits within ``MIXTRAL_CHECK_TOL`` of the largest on every
    sequence whose routing never differed."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import registry
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.precision.qat import quantize_param_tree
    from repro_torch.quant import PrecisionPlan

    out = {}
    for bits, kv_bits in MIXTRAL_CHECKS:
        plan = PrecisionPlan(model_bits=bits, kv_bits=kv_bits,
                             model_storage="int" if bits else "fake")
        cfg = configs.get_reduced(MIXTRAL, dtype=torch.float32, precision=plan)
        tree = T.init_params(cfg, seed=0, device="cpu")
        tree = quantize_param_tree(tree, bits=bits) if bits else tree
        for plen in MIXTRAL_CHECK_PROMPTS:
            prompt = torch.from_numpy(np.random.default_rng(plen).integers(
                0, cfg.vocab_size, (2, plen)))
            lgs, logs, fed = {}, {}, None
            for label, where in (("cpu", "cpu"), ("card", dev)):
                p = _tree_to(tree, where)
                step = make_serve_step(cfg)
                with _routing([]) as log, registry.using("cuda"):   # CPU: the plain versions
                    logits, state = make_prefill_step(cfg, pad_to=plen + 9)(
                        p, {"tokens": prompt.to(where)})
                    got = [logits]
                    for i in range(8):
                        tok = torch.argmax(got[-1], -1) if fed is None else fed[i]
                        lg, _, state = step(p, state, tok.to(where, torch.int32)[:, None])
                        got.append(lg[:, 0])
                lgs[label] = [t.float().cpu()[:, :cfg.vocab_size] for t in got]
                logs[label] = log
                fed = [t.argmax(-1) for t in lgs["cpu"]]
                if where != "cpu" and state.layers.k.shape[2] != cfg.window:
                    raise AssertionError(f"[check mixtral] ring of {state.layers.k.shape[2]}")
            n_route, gap = _routing_diffs(logs["card"], logs["cpu"], cfg.top_k)
            res = _forced_tokens(lgs["card"], lgs["cpu"],
                                 _routed(logs["card"], logs["cpu"], 2, cfg.n_layers, 8, False),
                                 HYBRID_TIE["float32"])
            res.update(routing_choices_apart=n_route, routing_largest_gap=gap)
            gated = not kv_bits
            print(f"[check] reduced {MIXTRAL} f32 weight/KV bits {bits or 'raw'}/"
                  f"{kv_bits or 'raw'} legacy, prompts of {plen} (window {cfg.window}): card "
                  f"vs CPU plain path, fed the CPU's tokens — greedy tokens equal "
                  f"{res['tokens_equal']}/{res['of']} ({res['near_ties']} within "
                  f"{HYBRID_TIE['float32']:g} of a tie, {res['excused_by_routing']} after a "
                  f"routing difference); routing choices apart {n_route} (largest CPU gap "
                  f"there {gap:.3e}, bound {MOE_ROUTE_TIE:g}); logits max rel diff "
                  f"{res['logits_max_rel_diff']:.2e}, "
                  f"{_fmt(res['logits_max_rel_diff_same_routing'])} where the routing never "
                  f"differed ({'tol %g' % MIXTRAL_CHECK_TOL if gated else 'reported'})",
                  flush=True)
            if res["tokens_equal"] != res["of"] or gap >= MOE_ROUTE_TIE or \
                    (gated and (res["logits_max_rel_diff_same_routing"] or 0.0)
                     > MIXTRAL_CHECK_TOL):
                raise AssertionError(f"[check mixtral] bits {bits}/{kv_bits} prompt {plen}: "
                                     f"{res}")
            out[f"{bits}_{kv_bits}_{plen}"] = res
    return out


def check_qmm_vlm(dev, flush):
    """B5 at every (K, N) of llama-3.2-vision-11b (``VLM_QMM_KN``), int8
    and int4, at decode M 4 (SIMT) and the prefill's M 4096 (tensor
    cores), and the cross blocks' k and v of the 4 × 4096 vision tokens at
    M 16384."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(16)
    bsz, plen = VLM_RUN["batch"], VLM_RUN["prompt_len"]
    rows = []
    for bits in (8, 4):
        for (k, n), what in VLM_QMM_KN.items():
            for m, role in ((bsz, "decode"), (bsz * plen, "prefill")):
                rows.append(_qmm_row(dev, gen, flush, bits, m, k, n,
                                     f" (llama-3.2-vision {what}; {role})"))
        rows.append(_qmm_row(dev, gen, flush, bits, VLM_CROSS_M, 4096, 1024,
                             " (llama-3.2-vision cross k, v of the vision tokens)"))
    return rows


def check_qmm_audio(dev, flush):
    """B5 at every (K, N) of musicgen-medium — q, k, v, o (1536, 1536),
    gate and up (1536, 6144), down (6144, 1536) — int8 and int4, at decode
    M 4 and each prompt bucket of the trace [serve-audio] serves it."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(17)
    ms = {SERVE["max_slots"]: "decode"}
    for m in sorted(_prompt_buckets(AUDIO)):
        ms[m] = f"prefill, bucket {m}"
    rows = []
    for bits in (8, 4):
        for (k, n), what in _dense_kn(AUDIO).items():
            for m, role in ms.items():
                rows.append(_qmm_row(dev, gen, flush, bits, m, k, n,
                                     f" (musicgen {what}; {role})"))
    return rows


def check_paged_attn_audio(dev, flush):
    """B10 at musicgen-medium's MHA layout (24 query and 24 KV heads of 64:
    R 1 at D 64, which no earlier path ran) at ``ATTN_LENS``, KV bits 0, 8
    and 4: [serve-audio]'s rows."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(5)
    return _attn_layout_rows(dev, flush, gen, ATTN_AUDIO_LAYOUT, ATTN_LENS, True)


def _vlm_width(cfg) -> tuple:
    return _width(cfg) + (cfg.cross_attn_every, cfg.n_vis_tokens)


def _vlm_matrix_params(cfg) -> int:
    """Entries of every matmul weight of a vlm model: q, k, v, o, gate, up
    and down of each self layer, q, k, v and o of each cross block."""
    d, q, kv = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    attn_ = 2 * d * q + 2 * d * kv
    return cfg.n_layers * (attn_ + 3 * d * cfg.d_ff) + \
        cfg.n_layers // cfg.cross_attn_every * attn_


def _vision_stand_ins(dev):
    """The 4 × 4096 f32 vision stand-ins, normal from ``VLM_VISION_SEED``."""
    import torch

    rng = np.random.default_rng(VLM_VISION_SEED)
    vis = rng.standard_normal((VLM_RUN["batch"], 4096, 4096), dtype=np.float32)
    return torch.from_numpy(vis).to(dev)


def _serve_vlm_bits(dev, checked, bits: int, vision):
    """One [serve-vlm] run at weight/KV bits ``bits`` (see
    :func:`serve_vlm`); returns (run, cross blocks 0 and 7 at 8 bits, else
    None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import prng
    from repro_torch.kernels import paged_attn as PA
    from repro_torch.kernels import qmm as Q
    from repro_torch.launch import serve as S
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import layer_view
    from repro_torch.quant import tree_nbytes

    bsz, plen, gen = VLM_RUN["batch"], VLM_RUN["prompt_len"], VLM_RUN["gen"]
    tag = f"[serve-vlm] {bits}/{bits}"
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    plan = S._resolve_plan(None, bits, bits)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg, params = S._build(VLM, reduced=False, plan=plan, seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_cross = cfg.n_layers // cfg.cross_attn_every
    print(f"{tag} build: {_vlm_matrix_params(cfg) / 1e9:.2f} B matmul weights drawn and "
          f"encoded a layer at a time in {build_s:.1f} s", flush=True)
    if _vlm_width(cfg) != VLM_WIDTH or cfg.family != "vlm":
        raise AssertionError(f"not full-width {VLM}: {cfg}")
    prompts = prng.randint(prng.fold_in(prng.PRNGKey(0), 1), (bsz, plen), 0,
                           cfg.vocab_size, device=dev)
    batch = {"tokens": prompts, "vision": vision}
    prefill = make_prefill_step(cfg, pad_to=plen + gen)
    step = make_serve_step(cfg)
    # the main path: one prefill and gen decode steps (a warm-up step, thrown
    # away as serve() throws it, then gen − 1 timed ones)
    Q.reset_counters()
    PA.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    prefill_qmm = Q.launches
    first = torch.argmax(logits, -1).to(torch.int32)[:, None]
    step(params, state, first)
    torch.cuda.synchronize()
    out = [prompts, first]
    t0 = time.perf_counter()
    st = state
    for _ in range(gen - 1):
        _, nxt, st = step(params, st, out[-1])
        out.append(nxt[:, None])
    tokens = torch.cat(out, dim=1)
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / (gen - 1)
    peak = torch.cuda.max_memory_allocated() - base
    launches = {"qmm": Q.launches, "paged_decode_attn": PA.launches}
    cores = _core_gate(tag, Q, checked)
    shapes = dict(Q.shape_launches)
    tokens = tokens.cpu().numpy()
    want = {"qmm": VLM_QMM_PREFILL + VLM_QMM_STEP * gen, "paged_decode_attn": 0}
    if prefill_qmm != VLM_QMM_PREFILL or launches != want:
        raise AssertionError(f"{tag} launches {launches} (prefill qmm {prefill_qmm}), "
                             f"expected {want}")
    cross_m = sum(c for (packed, m, k, n), c in shapes.items() if m == VLM_CROSS_M)
    if cross_m != 2 * n_cross:
        raise AssertionError(f"{tag} {cross_m} qmm launches at the vision tokens' M "
                             f"{VLM_CROSS_M}, expected {2 * n_cross}")
    if tokens.shape != (bsz, plen + gen) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab_size:
        raise AssertionError(f"{tag} tokens {tokens.shape}, range "
                             f"{tokens.min()}..{tokens.max()}")
    ring, cross = st.layers, st.cross
    cross_bytes = sum(t.numel() * t.element_size() for t in cross.values())
    if ring.k.shape[2] != plen + gen or cross_bytes != VLM_CROSS_BYTES \
            or any(t.dtype != cfg.dtype or tuple(t.shape) != (n_cross, bsz, 4096, 8, 128)
                   for t in cross.values()) \
            or not torch.equal(cross["k"], state.cross["k"]):
        raise AssertionError(f"{tag} ring of {ring.k.shape[2]} rows; cross caches "
                             f"{[(tuple(t.shape), t.dtype) for t in cross.values()]}, "
                             f"{cross_bytes} bytes")
    code_bytes, weight_bytes = _code_bytes(params), tree_nbytes(params)
    table_bytes = tree_nbytes(params["embed"])
    if code_bytes != _vlm_matrix_params(cfg) * bits // 8 or peak >= 80e9:
        raise AssertionError(f"{tag} code bytes {code_bytes} (expected "
                             f"{_vlm_matrix_params(cfg) * bits // 8}), peak {peak}")
    del st
    # a profiled prefill: device ms, qmm's share and the cross blocks' (their
    # device time read by CUDA events around each block: the queue stays full)
    t1 = time.perf_counter()
    marks, block = [], T._cross_block_kv

    def timed_block(cfg_, blk, x, vis):
        s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s_.record()
        res = block(cfg_, blk, x, vis)
        e_.record()
        marks.append((s_, e_))
        return res

    T._cross_block_kv = timed_block
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prefill(params, batch)
            torch.cuda.synchronize()
    finally:
        T._cross_block_kv = block
    by_kernel, n_events = _device_kernels(prof)
    device_ms = sum(by_kernel.values())
    qmm_ms = sum(v for k_, v in by_kernel.items() if "qmm" in k_ or "splitk_reduce" in k_)
    cross_ms = sum(s_.elapsed_time(e_) for s_, e_ in marks)
    if len(marks) != n_cross or not device_ms or not 0 < qmm_ms <= device_ms:
        raise AssertionError(f"{tag} profiled prefill: device {device_ms} ms, qmm {qmm_ms}, "
                             f"{len(marks)} cross blocks timed")
    Q.reset_counters()
    prof_dec = profile_steps(step, params, state, first, 1)
    if not prof_dec["device_ms_per_step"]:
        raise AssertionError(f"{tag} the decode profile read no device time")
    profiles_s = time.perf_counter() - t1
    _core_gate(f"{tag} checks", Q, checked)
    blocks = None
    if bits == 8:
        blocks = {i: _clone_tree(layer_view(params["cross"], i)) for i in CROSS_CHECK_BLOCKS}
    run = {"arch": VLM, **VLM_RUN, "weight_bits": bits, "kv_bits": bits,
           "tokens_shape": list(tokens.shape), "build_s": build_s,
           "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
           "decode_tokens_per_s": 1e3 * bsz / decode_ms,
           "prefill_device_ms": device_ms, "prefill_qmm_device_ms": qmm_ms,
           "prefill_cross_ms": cross_ms, "prefill_device_events": n_events,
           "prefill_top_kernels_ms": dict(sorted(by_kernel.items(),
                                                 key=lambda kv: -kv[1])[:8]),
           "peak_bytes": peak, "launches": launches, "qmm_launches_by_core": cores,
           "qmm_launches_prefill": prefill_qmm, "qmm_launches_per_decode_step": VLM_QMM_STEP,
           "qmm_shape_launches": [[*k_, v] for k_, v in shapes.items()],
           "ring_rows": ring.k.shape[2], "cross_cache_bytes": cross_bytes,
           "ring_bytes_per_sequence": tree_nbytes(ring._asdict()) // bsz,
           "code_bytes": code_bytes, "table_bytes": table_bytes,
           "weight_bytes": weight_bytes, "decode_profile": prof_dec,
           "profiles_s": profiles_s}
    print(f"{tag}: {VLM} full width, tokens {tuple(tokens.shape)} in vocab; peak "
          f"{peak / 2**30:.2f} GiB over the build and the run; weights "
          f"{weight_bytes / 1e9:.3f} GB (codes {code_bytes / 1e9:.3f}, bf16 table "
          f"{table_bytes / 1e9:.3f}); prefill {prefill_ms:.1f} ms ({bsz} x {plen}, "
          f"{prefill_qmm} qmm launches, {cross_m} at the vision tokens' M {VLM_CROSS_M}); "
          f"profiled prefill: device {device_ms:.2f} ms, qmm {qmm_ms:.2f} (share "
          f"{qmm_ms / device_ms:.3f}), the {n_cross} cross blocks {cross_ms:.2f} (share "
          f"{cross_ms / device_ms:.3f}); ring {ring.k.shape[2]} rows a layer, cross caches "
          f"{cross_bytes:,} bytes raw {str(cfg.dtype).removeprefix('torch.')}; qmm "
          f"{VLM_QMM_STEP} a decode step; decode {decode_ms:.2f} ms/step, profiled: device "
          f"{prof_dec['device_ms_per_step']:.2f} ms, idle share "
          f"{prof_dec['device_idle_share']:.3f}, wall {prof_dec['wall_ms_per_step']:.1f} "
          f"ms; launches {launches} {cores}; profiles {profiles_s:.1f} s", flush=True)
    del params, state, logits
    torch.cuda.empty_cache()
    return run, blocks


def serve_vlm(dev, checked):
    """Slice 12's vlm path: full-width llama-3.2-vision-11b built by
    ``launch.serve._build`` (every weight encoded a layer at a time as it
    is drawn; the build timed) at weight/KV bits 8/8 and 4/4, through
    ``make_prefill_step(cfg, pad_to=1056)`` and ``make_serve_step`` on
    ``VLM_RUN``'s prompts and the vision stand-ins, the ``qmm`` and
    ``paged_decode_attn`` counters set to 0 just before and read just after
    the prefill and the decode steps: ``qmm`` 312 a prefill (2 × 8 of them
    at the vision tokens' M 16384) and 296 a decode step, at checked shapes
    on plan's core, ``paged_decode_attn`` 0 (the legacy loop attends in
    plain PyTorch, as the reference); in-vocab tokens; the ring 1056 rows a
    layer; the cross caches 8 × 2 planes of (4, 4096, 8, 128) raw bf16
    (536,870,912 bytes) at both bit widths, left as they were by decode;
    the codes' bytes those of every matrix at the bits; peak memory under
    80 GB. Then a profiled prefill (device ms, ``qmm``'s share, the cross
    blocks') and a profiled decode step (device ms, idle share, wall).
    Returns ({bits: run}, cross blocks 0 and 7 of the int8 build for
    [check cross], the vision stand-ins)."""
    import torch

    vision = _vision_stand_ins(dev)
    out, blocks = {}, None
    for bits in VLM_BITS:
        out[f"{bits}/{bits}"], got = _serve_vlm_bits(dev, checked, bits, vision)
        blocks = blocks or got
        torch.cuda.empty_cache()
    return out, blocks, vision


def check_cross(dev, blocks, vision):
    """The cross block's decode against its prefill at full width: for
    cross blocks 0 and 7 of the int8 build at f32, on the vision stand-ins
    and 4 × 64 random f32 rows, ``_cross_block_kv`` over the 64 rows (its
    K/V of the vision tokens cached) against ``_cross_decode`` of the last
    row on that cache: the two contributions within ``CROSS_CHECK_TOL`` of
    the prefill's largest; the contribution nonzero; and on zero vision
    tokens the block adds exactly 0 (ROADMAP C25)."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(configs.get_config(VLM), dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(22)
    x = torch.randn(VLM_RUN["batch"], 64, cfg.d_model, generator=gen, device=dev)
    out = {}
    with torch.no_grad():
        for i, blk in blocks.items():
            full, ck, cv = T._cross_block_kv(cfg, blk, x, vision)
            want = (full - x)[:, -1:]
            got = T._cross_decode(cfg, blk, x[:, -1:], ck, cv) - x[:, -1:]
            scale = float(want.abs().max())
            zero, zk, zv = T._cross_block_kv(cfg, blk, x, torch.zeros_like(vision))
            row = {"gap": float((got - want).abs().max()) / scale, "largest": scale,
                   "zero_vision_adds_exactly_0": bool(torch.equal(zero, x)),
                   "zero_vision_kv_all_0": not (zk.any() or zv.any())}
            print(f"[check cross] {VLM} cross block {i}, f32, int8 weights: prefill's "
                  f"contribution at the last of 64 positions against _cross_decode's on the "
                  f"cached K/V of 4096 vision tokens: gap {row['gap']:.3e} of the largest "
                  f"{scale:.4g} (tol {CROSS_CHECK_TOL:g}); zero vision tokens: K/V all 0 "
                  f"{row['zero_vision_kv_all_0']}, the block adds exactly 0 "
                  f"{row['zero_vision_adds_exactly_0']}", flush=True)
            if not (row["gap"] <= CROSS_CHECK_TOL and scale > 0
                    and row["zero_vision_adds_exactly_0"] and row["zero_vision_kv_all_0"]):
                raise AssertionError(f"[check cross] block {i}: {row}")
            out[i] = row
    return out


def agree_vlm(dev):
    """The reduced llama-3.2-vision-11b (4 layers, a cross block after
    every 2 over 16 vision tokens) at f32, weight/KV bits ``VLM_CHECKS``,
    through the legacy loop (``make_prefill_step`` + 8 ``make_serve_step``
    steps) on 2 prompts of 40 and seeded vision tokens, on the card
    (kernels) against the CPU's plain path from the same weights, both the
    ``cuda`` backend, each fed the CPU's greedy tokens: tokens equal, and
    raw-KV logits within ``VLM_CHECK_TOL`` of the largest."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import registry
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.precision.qat import quantize_param_tree
    from repro_torch.quant import PrecisionPlan

    out = {}
    for bits, kv_bits in VLM_CHECKS:
        plan = PrecisionPlan(model_bits=bits, kv_bits=kv_bits,
                             model_storage="int" if bits else "fake")
        cfg = configs.get_reduced(VLM, dtype=torch.float32, precision=plan)
        tree = T.init_params(cfg, seed=0, device="cpu")
        tree = quantize_param_tree(tree, bits=bits) if bits else tree
        rng = np.random.default_rng(3)
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))
        vis = torch.from_numpy(rng.standard_normal((2, cfg.n_vis_tokens, cfg.d_model),
                                                   dtype=np.float32))
        lgs, fed = {}, None
        for label, where in (("cpu", "cpu"), ("card", dev)):
            p = _tree_to(tree, where)
            step = make_serve_step(cfg)
            with registry.using("cuda"):          # CPU: the kernels' plain versions
                logits, state = make_prefill_step(cfg, pad_to=49)(
                    p, {"tokens": prompt.to(where), "vision": vis.to(where)})
                got = [logits]
                for i in range(8):
                    tok = torch.argmax(got[-1], -1) if fed is None else fed[i]
                    lg, _, state = step(p, state, tok.to(where, torch.int32)[:, None])
                    got.append(lg[:, 0])
            lgs[label] = [t.float().cpu()[:, :cfg.vocab_size] for t in got]
            fed = [t.argmax(-1) for t in lgs["cpu"]]
        same = sum(int(torch.equal(a.argmax(-1), b.argmax(-1)))
                   for a, b in zip(lgs["card"], lgs["cpu"]))
        gap = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(lgs["card"], lgs["cpu"]))
        gated = not kv_bits
        print(f"[check] reduced {VLM} f32 weight/KV bits {bits or 'raw'}/{kv_bits or 'raw'} "
              f"legacy, 2 prompts of 40 with seeded vision tokens: card vs CPU plain path, "
              f"fed the CPU's tokens — greedy tokens equal at {same}/9 positions; logits max "
              f"rel diff {gap:.2e} ({'tol %g' % VLM_CHECK_TOL if gated else 'reported'})",
              flush=True)
        if same != 9 or (gated and gap > VLM_CHECK_TOL):
            raise AssertionError(f"[check vlm] bits {bits}/{kv_bits}: tokens {same}/9, "
                                 f"gap {gap}")
        out[f"{bits}_{kv_bits}"] = {"positions_equal": same, "logits_max_rel_diff": gap}
    return out


def serve_audio(dev, checked):
    """Slice 12's audio path: ``serve_engine`` on full-width
    musicgen-medium at weight/KV bits 8/8 and 4/4 on the slice-1 trace with
    every gate of ``[serve]`` (via :func:`serve`: ``qmm`` 7 × 48 launches a
    decode step and a prefill, at checked shapes on plan's core;
    ``paged_decode_attn`` 48 a step), peak memory and a 2-step decode
    profile."""
    import torch

    out = {}
    for bits in AUDIO_BITS:
        launches, shapes, summary = serve(bits, dev, checked, AUDIO, "serve-audio",
                                          profile_steps=DENSE_PROFILE_STEPS)
        if summary["launches_per_decode_step"] != {"qmm": 7 * 48, "paged_decode_attn": 48}:
            raise AssertionError(f"[serve-audio] {summary['launches_per_decode_step']}")
        out[f"{bits}/{bits}"] = (launches, shapes, summary)
        torch.cuda.empty_cache()
    return out


def agree_audio(dev):
    """The reduced musicgen-medium through the paged engine on the card
    (kernels) and on the CPU's plain path from the same weights (the
    slice-1 trace's shape, 8 requests) at ``AUDIO_CHECKS``: at f32 (int
    weights and KV) every request's tokens equal; at raw KV the model runs
    at bf16, as B10 takes raw pages in bf16 alone, and the first generated
    token of every request must agree, the whole sequences reported (bf16
    products rounded in another order may part at a near tie later)."""
    import torch
    from repro_torch import configs
    from repro_torch.launch.serve import make_trace
    from repro_torch.models import transformer as T
    from repro_torch.precision.qat import quantize_param_tree
    from repro_torch.quant import PrecisionPlan
    from repro_torch.serve import ServeEngine

    out = {}
    for dtype, bits, kv_bits in AUDIO_CHECKS:
        plan = PrecisionPlan(model_bits=bits, kv_bits=kv_bits,
                             model_storage="int" if bits else "fake")
        cfg = configs.get_reduced(AUDIO, dtype=getattr(torch, dtype), precision=plan)
        params = T.init_params(cfg, seed=0, device="cpu")
        params = quantize_param_tree(params, bits=bits) if bits else params
        res = {}
        for where in (dev, "cpu"):
            eng = ServeEngine(params, cfg, max_slots=4, page_size=8, max_seq_len=56,
                              backend="cuda", device=where)
            res[str(where)] = eng.run(make_trace(8, cfg.vocab_size, max_new=16,
                                                 max_prompt=32, seed=0))
        on_card, on_cpu = res[str(dev)], res["cpu"]
        first = sum(int(on_card[r].tokens[on_card[r].prompt_len]
                        == on_cpu[r].tokens[on_cpu[r].prompt_len]) for r in on_cpu)
        same = sum(int(np.array_equal(on_card[r].tokens, on_cpu[r].tokens)) for r in on_cpu)
        gated = same if dtype == "float32" else first
        print(f"[check] reduced {AUDIO} {dtype} weight/KV bits {bits or 'raw'}/"
              f"{kv_bits or 'raw'}: card kernels vs CPU plain path through the engine — "
              f"first tokens equal {first}/8, whole sequences equal {same}/8 (gated: "
              f"{'whole sequences' if dtype == 'float32' else 'first tokens'})", flush=True)
        if gated != 8:
            raise AssertionError(f"[check audio] {dtype} bits {bits}/{kv_bits}: first "
                                 f"{first}/8, sequences {same}/8 equal")
        out[f"{dtype}_{bits}_{kv_bits}"] = {"first_tokens_equal": first,
                                            "sequences_equal": same}
    return out


def _feature_trace(vocab: int, sample: bool = True, spec: dict = FEAT_PREFIX):
    """The shared-prefix trace of ``spec`` (default [serve-features]'
    FEAT_PREFIX) as the port's Requests over ``vocab``, sampled at
    FEAT_SAMPLE unless ``sample`` is False: request i extends family i mod
    ``families``'s prefix by a private suffix."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(spec["seed"])
    fams = [rng.integers(0, vocab, spec["prefix_len"]) for _ in range(spec["families"])]
    out = []
    for rid in range(spec["n_requests"]):
        lo, hi = spec["suffix"]
        tail = rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
        budget = int(rng.integers(spec["max_new"][0], spec["max_new"][1] + 1))
        out.append(Request(rid=rid, prompt=np.concatenate([fams[rid % spec["families"]], tail]),
                           max_new_tokens=budget, **(FEAT_SAMPLE if sample else {})))
    return out


def _feature_ms() -> set:
    """The M at which [serve-features] launches ``qmm``: decode (4 slots),
    a prefill chunk (FEAT_CHUNK_M), each prompt bucket of the slice-1 trace
    and of the shared-prefix trace, and the profiles' 64-token prompts."""
    from repro_torch import configs

    page = SERVE["page_size"]
    trace = _feature_trace(configs.get_config("gemma-2b").vocab_size)
    return ({SERVE["max_slots"], FEAT_CHUNK_M, 64} | set(_prompt_buckets())
            | {-(-len(r.prompt) // page) * page for r in trace})


def check_qmm_features(dev, flush, checked):
    """``qmm`` at gemma-2b's four (K, N), int8, at every M of
    :func:`_feature_ms` that no earlier row checked (``checked``: their
    (packed, M, K, N) keys): the prefill chunk's M 32 and the shared-prefix
    trace's prompt buckets."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(14)
    rows = []
    for m in sorted(_feature_ms()):
        for k, n in QBP_KN:
            if (False, m, k, n) in checked:
                continue
            role = " (prefill chunk)" if m == FEAT_CHUNK_M else f" (prefill, bucket {m})"
            rows.append(_qmm_row(dev, gen, flush, FEAT_BITS, m, k, n, role))
    return rows


def check_paged_attn_features(dev, flush):
    """B10 at a prefill chunk's call ([serve-features]): FEAT_CHUNK_M
    queries at gemma-2b's (8, 1, 256) layout over int8 pages, every query
    on the same sequence's block table at ``seq_len = min(position + 1,
    prompt length)`` — a chunk at offset 32 of a 50-token prompt (the
    path's row) and, check-only, the last chunk of a FEAT_LONG_PROMPT-token
    prompt: each query re-reads the context, so a chunk at offset L asks
    for ~C·L rows where one gathered attention reads L."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(15)
    b, (h, hkv, d), page = FEAT_CHUNK_M, (8, 1, 256), SERVE["page_size"]
    rows = []
    for prompt, path in ((50, True), (FEAT_LONG_PROMPT, False)):
        maxp = -(-max(prompt, FEAT_CONTEXT) // page)
        offset = (prompt - 1) // b * b
        q = torch.randn(b, h, d, generator=gen, device=dev).to(torch.bfloat16)
        row = (torch.randperm(maxp, generator=gen, device=dev) + 1).to(torch.int32)
        bt = row[None].expand(b, maxp).contiguous()
        lens = torch.tensor([min(offset + i + 1, prompt) for i in range(b)], dtype=torch.int32,
                            device=dev)
        pool = _attn_pool(dev, gen, FEAT_BITS, maxp + 1, page, hkv, d)
        out = _attn_row(flush, (q, *pool, bt, lens), FEAT_BITS, path, shared=True)
        if path:
            out["name"] += " (prefill chunk)"
        else:
            out["name"] = out["name"].replace(" (check only)", "").split(" lens")[0] \
                + f" lens {offset + 1}–{prompt} (a long prompt's last chunk; check only)"
        out["path"] = path
        rows.append(out)
    return rows


def _in_waves(engine, reqs, families: int) -> dict:
    """Serve ``reqs`` on ``engine``: the first ``families`` (one request of
    each prefix family) arrive first, the rest once those are prefilled
    (their pages then sit in the trie). Returns rid → Finished."""
    out = {}
    for r in reqs[:families]:
        engine.submit(r)
    while engine._queue or engine.n_prefilling:
        out.update({f.rid: f for f in engine.step()})
    for r in reqs[families:]:
        engine.submit(r)
    while engine.busy:
        out.update({f.rid: f for f in engine.step()})
    return out


def _tokens(results) -> dict:
    return {rid: f.tokens.tolist() for rid, f in sorted(results.items())}


def _profile_live(engine, steps: int, what: str):
    """``profile_window`` over ``steps`` decode steps of 4 live sampled
    requests of 64-token prompts (rids 100–103), once all four decode."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(7)
    for i in range(4):
        engine.submit(Request(rid=100 + i, prompt=rng.integers(0, engine.cfg.vocab_size, 64),
                              max_new_tokens=steps + 8, seed=7, **FEAT_SAMPLE))
    while engine._queue or engine.n_prefilling or engine.n_active < 4:
        engine.step()
    out = profile_window(engine.step, steps, f"{what} x 4 live slots")
    while engine.busy:
        engine.step()
    return out


def serve_features(dev, checked):
    """Slice 13's path: full-width gemma-2b at 8/8 (one weight tree, built
    once, shared by every engine) through ``ServeEngine`` and
    ``ReplicaSet``, every request sampled at FEAT_SAMPLE, in five runs. The
    ``qmm``, ``paged_decode_attn`` and threefry counters are set to 0 just
    before each run and must read > 0 just after; every ``qmm`` launch must
    be at a checked (packed, M, K, N) on plan's core; ``qmm`` must launch 7
    × 18 times and B10 18 times a decode step, a prefill chunk and (``qmm``)
    a monolithic prefill.

    1. sampled: the slice-1 trace, monolithic; two of its requests
       re-served alone give the same tokens; a decode profile;
    2. shared prefix: FEAT_PREFIX's trace with ``prefix_cache=True,
       chunk_pages=2`` (leaders first): ≥ FEAT_MIN_HITS prefix hits, the
       same tokens as the trace chunked without a cache, leak-free after
       ``release_prefix_cache``; a decode profile;
    3. preempting: that trace monolithic under ``reserve='none'`` with a
       pool that holds the first four prompts' pages and nothing more:
       ≥ 1 preemption, the tokens of ``reserve='full'``;
    4. faults on a ``VirtualClock``: ``nan_logits`` on one request of the
       slice-1 trace fails it alone with reason 'nan' (the others keep run
       1's tokens); a ``kv_flip`` in a shared trie page between two waves
       of the shared-prefix trace gets the page evicted, and the second
       wave's tokens equal run 2's cache-free run's;
    5. ``ReplicaSet(2)`` on the card (``dispatch='prefix'``), replica 0
       raising at set steps FEAT_RAISE_STEPS: every request finishes once
       with run 2's tokens, replica 0 restarts, every pool drains
       leak-free."""
    import torch
    from repro_torch.kernels import paged_attn as PA
    from repro_torch.kernels import qmm as Q
    from repro_torch.kernels import threefry as TF
    from repro_torch.launch.serve import HealthConfig, ReplicaSet, _build, make_trace
    from repro_torch.quant import PrecisionPlan
    from repro_torch.serve import FaultInjector, FaultSpec, ServeEngine, VirtualClock
    from repro_torch.serve import pages as pg

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    plan = PrecisionPlan(model_bits=FEAT_BITS, kv_bits=FEAT_BITS, model_storage="int")
    t0 = time.perf_counter()
    cfg, params = _build("gemma-2b", reduced=False, plan=plan, seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if _width(cfg) != DENSE_WIDTH["gemma-2b"]:
        raise AssertionError(f"not full-width gemma-2b: {cfg}")
    L, V = cfg.n_layers, cfg.vocab_size
    ekw = dict(plan=plan, max_slots=SERVE["max_slots"], page_size=SERVE["page_size"],
               max_seq_len=FEAT_CONTEXT, device=dev)

    def engine(**kw):
        return ServeEngine(params, cfg, **ekw, **kw)

    trace1 = make_trace(SERVE["n_requests"], V, max_new=SERVE["max_new"],
                        max_prompt=SERVE["max_prompt"], seed=0, **FEAT_SAMPLE)
    trace2 = _feature_trace(V)
    fams = FEAT_PREFIX["families"]
    acc = {"qmm": collections.Counter(), "tf": collections.Counter(),
           "attn_decode": 0, "attn_chunk": 0}
    report = {"build_s": build_s}

    def counted(tag, fn):
        Q.reset_counters()
        PA.launches = 0
        TF.reset_counts()
        t0 = time.perf_counter()
        engines, out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"qmm": Q.launches, "paged_decode_attn": PA.launches,
                    "threefry": TF.launches}
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"[serve-features] {tag}: kernel {name} was not launched")
        cores = _core_gate(f"[serve-features] {tag}", Q, checked)
        st = {k: (max if k.startswith("max_") else sum)(e.stats[k] for e in engines)
              for k in engines[0].stats}
        prefills = sum(e.stats["admitted"] for e in engines if e.chunk_pages is None)
        want = {"qmm": 7 * L * (st["decode_steps"] + st["prefill_chunks"] + prefills),
                "paged_decode_attn": L * (st["decode_steps"] + st["prefill_chunks"])}
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"[serve-features] {tag}: launches {launches}, expected {want}")
        acc["qmm"].update(Q.shape_launches)
        acc["tf"].update(TF.shape_launches)
        acc["attn_decode"] += L * st["decode_steps"]
        acc["attn_chunk"] += L * st["prefill_chunks"]
        times = [t for e in engines for t in e.decode_times]
        summary = {"wall_s": wall, "launches": launches, "qmm_launches_by_core": cores,
                   "threefry_shape_launches": sorted([*k, n] for k, n in
                                                     TF.shape_launches.items()),
                   "mean_decode_step_ms": 1e3 * statistics.mean(times) if times else None,
                   **{k: st[k] for k in ("decode_steps", "decode_tokens", "prefill_tokens",
                                         "prefill_chunks", "max_prefill_tokens_per_step",
                                         "prefix_hits", "prefix_misses",
                                         "prefix_hit_tokens", "preemptions", "quarantined",
                                         "kv_flips", "finished")}}
        summary.update(out.pop("summary", {}))
        print(f"[serve-features] {tag}: {st['finished']} requests finished in "
              f"{st['decode_steps']} decode steps (+{st['prefill_tokens']} prefill tokens, "
              f"{st['prefill_chunks']} chunks, at most {st['max_prefill_tokens_per_step']} "
              f"a step); prefix hits {st['prefix_hits']} ({st['prefix_hit_tokens']} tokens), "
              f"preemptions {st['preemptions']}, quarantined {st['quarantined']}; "
              f"decode {summary['mean_decode_step_ms'] or float('nan'):.2f} ms/step; "
              f"launches {launches} {cores}; wall {wall:.1f} s", flush=True)
        report[tag] = summary
        return out

    def check_finished(results, n, what):
        if sorted(results) != list(range(n)):
            raise AssertionError(f"[serve-features] {what}: finished {sorted(results)}")
        for f in results.values():
            gen = f.tokens[f.prompt_len:]
            if len(gen) != f.n_generated or (f.reason != "nan" and f.n_generated < 1) \
                    or (len(gen) and (gen.min() < 0 or gen.max() >= V)):
                raise AssertionError(f"[serve-features] {what}: request {f.rid} {f.reason}, "
                                     f"{f.n_generated} tokens")

    # 1. sampled, monolithic; two requests alone; a decode profile
    def run1():
        eng = engine()
        res = eng.run(trace1)
        check_finished(res, len(trace1), "sampled")
        eng.allocator.check_leaks(0)
        engines = [eng]
        for rid in FEAT_SOLO:
            solo = engine()
            engines.append(solo)
            got = solo.run([trace1[rid]])[rid].tokens
            if not np.array_equal(got, res[rid].tokens):
                raise AssertionError(f"[serve-features] sampled: request {rid} alone gives "
                                     "other tokens than in the batch")
        run_ms = 1e3 * statistics.mean(eng.decode_times)
        prof = _profile_live(eng, FEAT_PROFILE_STEPS, "sampled decode steps")
        return engines, {"tokens": _tokens(res), "summary": {
            "profile": prof, "trace_decode_step_ms": run_ms}}

    sampled = counted("sampled", run1)

    # 2. the shared-prefix trace: prefix cache + chunks against chunks alone
    def run2():
        warm, cold = engine(prefix_cache=True, chunk_pages=FEAT_CHUNK_PAGES), \
            engine(chunk_pages=FEAT_CHUNK_PAGES)
        got = _in_waves(warm, trace2, fams)
        want = _in_waves(cold, trace2, fams)
        check_finished(got, len(trace2), "shared prefix")
        if warm.stats["prefix_hits"] < FEAT_MIN_HITS:
            raise AssertionError(f"[serve-features] shared prefix: "
                                 f"{warm.stats['prefix_hits']} prefix hits < {FEAT_MIN_HITS}")
        if _tokens(got) != _tokens(want):
            raise AssertionError("[serve-features] shared prefix: tokens differ from the "
                                 "same trace chunked without a cache")
        if warm.stats["max_prefill_tokens_per_step"] > FEAT_CHUNK_M:
            raise AssertionError("[serve-features] a step prefilled more than a chunk")
        used = warm.kv_pool_nbytes(used_only=True)
        cached = warm.prefix.n_pages
        released = warm.release_prefix_cache()
        warm.allocator.check_leaks(0)
        cold.allocator.check_leaks(0)
        run_ms = {"prefix": 1e3 * statistics.mean(warm.decode_times),
                  "chunked": 1e3 * statistics.mean(cold.decode_times)}
        prof = _profile_live(cold, FEAT_PROFILE_STEPS, "chunked decode steps")
        cold.allocator.check_leaks(0)
        return [warm, cold], {"tokens": _tokens(want), "summary": {
            "profile": prof, "trace_decode_step_ms": run_ms,
            "pages_cached_at_drain": cached, "pages_released": released,
            "kv_bytes_used_at_drain": used}}

    prefix = counted("shared prefix", run2)

    # 3. preemption under reserve='none', monolithic, against reserve='full'
    def run3():
        page = SERVE["page_size"]
        n_pages = 1 + sum(pg.pages_needed(len(r.prompt) + 1, page)
                          for r in trace2[:SERVE["max_slots"]])
        tight = engine(reserve="none", n_pages=n_pages)
        full = engine()
        got, want = tight.run(trace2), full.run(trace2)
        check_finished(got, len(trace2), "preempting")
        if tight.stats["preemptions"] < 1:
            raise AssertionError("[serve-features] preempting: no preemption")
        if _tokens(got) != _tokens(want):
            raise AssertionError("[serve-features] preempting: tokens differ from "
                                 "reserve='full'")
        tight.allocator.check_leaks(0)
        full.allocator.check_leaks(0)
        return [tight, full], {"summary": {"n_pages": n_pages}}

    counted("preempting", run3)

    # 4. faults on a virtual clock
    def run4():
        clock = VirtualClock()
        inj = FaultInjector([FaultSpec("nan_logits", **FEAT_NAN)], clock=clock)
        eng = engine(fault_injector=inj, clock=clock)
        res = eng.run(trace1)
        check_finished(res, len(trace1), "nan_logits")
        bad = {rid for rid, f in res.items() if f.reason == "nan"}
        if bad != {FEAT_NAN["rid"]} or eng.stats["quarantined"] != 1:
            raise AssertionError(f"[serve-features] nan_logits failed {sorted(bad)}")
        rest = {r: t for r, t in _tokens(res).items() if r not in bad}
        if rest != {r: t for r, t in sampled["tokens"].items() if r not in bad}:
            raise AssertionError("[serve-features] nan_logits changed another request")
        eng.allocator.check_leaks(0)
        flips = FaultInjector([], clock=clock)
        warm = engine(prefix_cache=True, chunk_pages=FEAT_CHUNK_PAGES, fault_injector=flips,
                      clock=clock)
        _in_waves(warm, trace2, fams)
        victim = warm.prefix.match(trace2[0].prompt)[0]
        flips.arm(FaultSpec("kv_flip", at_step=warm._step_no + 1, page=victim, **FEAT_FLIP))
        wave2 = _in_waves(warm, trace2, fams)
        if warm.stats["kv_flips"] != 1 or warm.prefix.corrupt_evictions < 1:
            raise AssertionError(f"[serve-features] kv_flip: {warm.stats['kv_flips']} flips, "
                                 f"{warm.prefix.corrupt_evictions} corrupt evictions")
        if _tokens(wave2) != prefix["tokens"]:
            raise AssertionError("[serve-features] kv_flip: the second wave's tokens differ "
                                 "from the cache-free run's")
        warm.release_prefix_cache()
        warm.allocator.check_leaks(0)
        fired = [(r["kind"], r["step"], r["replica"]) for r in (*inj.fired, *flips.fired)]
        return [eng, warm], {"summary": {
            "fired": fired, "corrupt_evictions": warm.prefix.corrupt_evictions,
            "quarantined_rids": sorted(bad)}}

    counted("faults", run4)

    # 5. two replicas on the card, replica 0 raising twice mid-trace
    def run5():
        clock = VirtualClock()
        inj = FaultInjector([FaultSpec("replica_raise", at_step=s, replica=0)
                             for s in FEAT_RAISE_STEPS], clock=clock)
        built = []

        def factory(i):
            built.append(engine(prefix_cache=True, chunk_pages=FEAT_CHUNK_PAGES, clock=clock,
                                fault_injector=inj, replica_id=i))
            return built[-1]

        rs = ReplicaSet(factory, 2, devices=[dev, dev], dispatch="prefix", clock=clock,
                        fault_injector=inj, health=HealthConfig(**FEAT_HEALTH))
        for r in trace2:
            rs.submit(r)
        out = {}
        for _ in range(10_000):
            if not rs._queue and not any(e.busy for e in rs.engines) \
                    and all(h.state == "healthy" for h in rs.health):
                break
            for rid, f in rs.step().items():
                if rid in out:
                    raise AssertionError(f"[serve-features] replicas: request {rid} "
                                         "finished twice")
                out[rid] = f
            clock.advance(0.01)
        check_finished(out, len(trace2), "replicas")
        states = [t[2] for t in rs.health[0].transitions]
        if (rs.stats["deaths"], rs.stats["restarts"]) != (1, 1) or rs.stats["migrated"] < 1 \
                or states != ["suspect", "dead", "recovering", "healthy"]:
            raise AssertionError(f"[serve-features] replicas: {rs.stats}, replica 0 {states}")
        if _tokens(out) != prefix["tokens"]:
            raise AssertionError("[serve-features] replicas: tokens differ from the "
                                 "fault-free run's")
        for e in rs.engines:
            e.release_prefix_cache()
            e.allocator.check_leaks(0)
        return built, {"summary": {"set_stats": dict(rs.stats), "dispatched": rs.dispatched,
                                   "replica0_transitions": states,
                                   "engines_built": len(built)}}

    counted("replicas", run5)
    torch.cuda.synchronize()
    report["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    report["launches"] = {"qmm_by_shape": sorted([*k, n] for k, n in acc["qmm"].items()),
                          "paged_decode_attn_decode": acc["attn_decode"],
                          "paged_decode_attn_chunk": acc["attn_chunk"]}
    # the phase's threefry launches: every run's, for the kernels line
    TF.reset_counts()
    TF.shape_launches.update(acc["tf"])
    TF.launches = sum(acc["tf"].values())
    print(f"[serve-features] gemma-2b full width 8/8: weights built in {build_s:.1f} s, "
          f"peak {report['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    del params
    torch.cuda.empty_cache()
    return report, acc


def agree_features(dev):
    """The reduced gemma-2b at f32, 8/8, through the engine on the card
    (kernels) and on the CPU's plain path from the same weights: a
    shared-prefix trace (FEAT_CHECK) chunked without and with the prefix
    cache and monolithic under ``reserve='none'`` with preemption (greedy:
    every token equal, and the same hits and preemptions), and the slice-1
    trace's shape sampled at FEAT_SAMPLE (a token may part only where the
    CPU's two largest perturbed scores lie within FEAT_SAMPLE_TIE)."""
    import torch
    from repro_torch import configs, prng
    from repro_torch.launch.serve import make_trace
    from repro_torch.models import transformer as T
    from repro_torch.precision.qat import quantize_param_tree
    from repro_torch.quant import PrecisionPlan
    from repro_torch.serve import ServeEngine
    from repro_torch.serve import pages as pg
    from repro_torch.serve import sampling as S

    plan = PrecisionPlan(model_bits=8, kv_bits=8, model_storage="int")
    cfg = configs.get_reduced("gemma-2b", dtype=torch.float32, precision=plan)
    params = quantize_param_tree(T.init_params(cfg, seed=0, device="cpu"), bits=8)
    greedy = _feature_trace(cfg.vocab_size, sample=False, spec=FEAT_CHECK)
    n_pages = 1 + sum(pg.pages_needed(len(r.prompt) + 1, 8) for r in greedy[:4])
    runs = {"chunked": (greedy, dict(chunk_pages=2)),
            "prefix": (greedy, dict(chunk_pages=2, prefix_cache=True)),
            "preempting": (greedy, dict(reserve="none", n_pages=n_pages)),
            "sampled": (make_trace(8, cfg.vocab_size, max_new=16, max_prompt=32, seed=0,
                                   **FEAT_SAMPLE), {})}
    gaps = {}
    plain = S.sample_tokens

    def recording(logits, temperature, top_k, keys):
        """The CPU run's gap between its two largest perturbed scores, by
        key (the key names the request and position)."""
        out = plain(logits, temperature, top_k, keys)
        if logits.device.type == "cpu":
            b, v = logits.shape
            t = torch.as_tensor(np.asarray(temperature), dtype=torch.float32).reshape(b)
            k = torch.as_tensor(np.asarray(top_k), dtype=torch.int64).reshape(b)
            kth = torch.sort(logits, dim=-1, descending=True).values.gather(
                1, (k.clamp(1, v) - 1)[:, None])
            masked = torch.where((k[:, None] <= 0) | (logits >= kth), logits, float("-inf"))
            u = prng.uniform(torch.as_tensor(keys).reshape(b, 2), (v,)).clamp_min(S.TINY)
            score = masked / torch.where(t > 0, t, 1.0)[:, None] - torch.log(-torch.log(u))
            top2 = torch.topk(score, 2, dim=-1).values
            for i in range(b):
                gaps[tuple(torch.as_tensor(keys).reshape(b, 2)[i].tolist())] = \
                    float(top2[i, 0] - top2[i, 1])
        return out

    out = {}
    S.sample_tokens = recording
    try:
        for name, (reqs, kw) in runs.items():
            res, stats = {}, {}
            for where in (dev, "cpu"):
                eng = ServeEngine(params, cfg, max_slots=4, page_size=8, max_seq_len=56,
                                  backend="cuda", device=where, **kw)
                res[str(where)] = (_in_waves(eng, reqs, FEAT_CHECK["families"])
                                   if kw.get("prefix_cache") else eng.run(reqs))
                stats[str(where)] = {k: eng.stats[k] for k in ("prefix_hits", "preemptions")}
                eng.release_prefix_cache()
                eng.allocator.check_leaks(0)
            on_card, on_cpu = res[str(dev)], res["cpu"]
            parted, worst = [], 0.0
            for rid, f in on_cpu.items():
                g = on_card[rid]
                if np.array_equal(g.tokens, f.tokens):
                    continue
                if name != "sampled":
                    raise AssertionError(f"[check serve-features] {name}: request {rid} "
                                         "parts between card and CPU")
                j = next(i for i in range(min(len(g.tokens), len(f.tokens)) - f.prompt_len)
                         if g.tokens[f.prompt_len + i] != f.tokens[f.prompt_len + i])
                req = next(r for r in reqs if r.rid == rid)
                base = prng.fold_in(prng.PRNGKey(req.seed), rid)
                key = tuple(S.slot_key(base, f.prompt_len + j).tolist())
                gap = gaps[key]
                worst = max(worst, gap)
                parted.append((rid, j, gap))
                if not gap < FEAT_SAMPLE_TIE:
                    raise AssertionError(f"[check serve-features] sampled request {rid} "
                                         f"parts at token {j}, perturbed-score gap {gap:.3g} "
                                         f">= {FEAT_SAMPLE_TIE}")
            if stats[str(dev)] != stats["cpu"]:
                raise AssertionError(f"[check serve-features] {name}: {stats}")
            same = len(on_cpu) - len(parted)
            print(f"[check] reduced gemma-2b f32 8/8 {name}: card kernels vs CPU plain path "
                  f"through the engine — sequences equal {same}/{len(on_cpu)}"
                  + (f", parted at near ties {parted}" if parted else "")
                  + f"; {stats['cpu']}", flush=True)
            out[name] = {"sequences_equal": same, "parted": parted, **stats["cpu"]}
    finally:
        S.sample_tokens = plain
    return out


def main():
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import torch
    except ImportError:
        _fail("PyTorch is not installed", 2)
    if not torch.cuda.is_available():
        _fail("no CUDA device (torch.cuda.is_available() is False)", 2)
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import _build
    except ImportError as e:
        _fail(f"the port's sources are missing next to this script ({e})", 3)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    global INT32_OPS
    INT32_OPS = _int32_rate()
    print(f"[env] int32 rate {INT32_OPS / 1e12:.3f} T ops/s ({INT32_PER_CLK_SM} a clock per SM, "
          f"CUDA guide throughput table for compute capability 9.0, at the maximum SM clock "
          f"nvidia-smi reports)", flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {sorted(_build.sources())} built in {build_s:.1f} s "
          f"into {_build.build_dir()}", flush=True)
    for name, info in sorted(_build.BUILD_LOG.items()):
        for line in info["ptxas"].splitlines():
            if "Used" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")

    from repro_torch import prng
    from repro_torch.kernels import threefry as TF

    phase_s = {}
    tf_path = collections.Counter()     # threefry launches of the main paths by (out, K, n)

    def phase(name, fn, *args, **kw):
        """Run one phase; keep and print its wall seconds. A main-path phase
        (not a kernel's, rows' or check's) sets the threefry counters to 0
        just before and adds what they read just after to ``tf_path``
        (launches made for timings and profiles are put back, as a phase
        that resets them for its own gates leaves only its last run's);
        no phase but a kernel's (whose plain versions take the int64 path)
        may make an int64 hash on the card: prng's counter of them is set to
        0 just before and must read 0 just after."""
        path = not name.startswith(("kernel", "rows", "check"))
        if path:
            TF.reset_counts()
        if not name.startswith("kernel"):
            TF.int64_cuda_planes = 0
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t0
        if path:
            tf_path.update(TF.shape_launches)
        if not name.startswith("kernel") and TF.int64_cuda_planes:
            raise AssertionError(f"[{name}] made {TF.int64_cuda_planes} int64 threefry "
                                 "hashes on the card: every plane must take the kernel")
        print(f"[phase] {name}: {phase_s[name]:.1f} s", flush=True)
        return out

    from repro_torch.core.linear import make_dataset

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    _warm_up(dev)
    qmm_rows = phase("kernel qmm", check_qmm, dev, flush)
    attn_rows = phase("kernel paged_decode_attn", check_paged_attn, dev, flush)
    tf_rows = phase("kernel threefry", check_threefry, dev, flush)
    ds_rows = phase("kernel ds_quant", check_ds_quant, dev, flush)
    qmv_rows = phase("kernel qmv", check_qmv, dev, flush)
    qmm_t_rows = phase("kernel qmm_t", check_qmm_t, dev, flush)
    adamw_rows = phase("kernel quant_adamw", check_quant_adamw, dev, flush)
    qbp_rows = phase("kernel qmm_bitplane", check_qmm_bitplane, dev, flush)
    qbp_same_rows = phase("rows qmm_bitplane", check_bitplane_rows, dev)
    absmax_rows = phase("kernel row_absmax", check_row_absmax, dev, flush)
    sq_rows = phase("kernel stoch_quant", check_stoch_quant, dev, flush)
    qout_rows = phase("kernel qmm_qout", check_qmm_qout, dev, flush)
    unembed_rows = phase("kernel qmm_t unembed", check_qmm_t_unembed, dev, flush)
    ssd_rows = phase("kernel ssd_chunk_scan", check_ssd, dev, flush)
    mamba_qmm_rows = phase("kernel qmm mamba2", check_qmm_ssm, dev, flush)
    dense_qmm_rows = phase("kernel qmm dense", check_qmm_dense, dev, flush)
    hybrid_ssd_rows = phase("kernel ssd zamba2", check_ssd, dev, flush, HYBRID_SSD_CASES)
    hybrid_qmm_rows = phase("kernel qmm zamba2", check_qmm_ssm, dev, flush, "zamba2-2.7b")
    moe_qmm_rows = phase("kernel qmm moe", check_qmm_moe, dev, flush)
    moe_attn_rows = phase("kernel paged_decode_attn moe", check_paged_attn_moe, dev, flush)
    mixtral_qmm_rows = phase("kernel qmm mixtral", check_qmm_mixtral, dev, flush)
    vlm_qmm_rows = phase("kernel qmm vlm", check_qmm_vlm, dev, flush)
    audio_qmm_rows = phase("kernel qmm audio", check_qmm_audio, dev, flush)
    audio_attn_rows = phase("kernel paged_decode_attn audio", check_paged_attn_audio, dev,
                            flush)
    feat_qmm_rows = phase("kernel qmm features", check_qmm_features, dev, flush,
                          {r["key"] for r in qmm_rows})
    feat_attn_rows = phase("kernel paged_decode_attn features", check_paged_attn_features,
                           dev, flush)
    gisette = make_dataset("gisette")
    qrows = phase("quantize-rows", quantize_rows_path, dev, gisette, flush)
    del flush
    torch.cuda.empty_cache()

    # every qmm launch of [serve], [serve-embed] and [train] must be at a
    # checked shape (those of [serve-mamba]: its own gate)
    checked = {r["key"] for r in qmm_rows}
    runs = {bits: phase(f"serve {bits}/{bits}", serve, bits, dev, checked)
            for bits in (8, 4)}
    small = phase("check serve", agree_small, dev)
    linear = phase("linear", train_linear_full, dev)
    linear_small = phase("check linear", agree_linear, dev)
    training = phase("train", train_full, dev, checked)
    train_small = phase("check train", agree_train, dev)
    # every qmm_bitplane launch of [serve-bitplane] and [spec] must be at a
    # checked (P, M, K, N), on the tensor cores
    qbp_checked = {r["key"] for r in qbp_rows}
    bitplane = phase("serve-bitplane", serve_bitplane, dev, qbp_checked)
    spec = phase("spec", spec_bitplane, dev, bitplane[8]["tokens"], qbp_checked)
    spec["control"] = phase("spec control", spec_bitplane, dev, bitplane[8]["tokens"],
                            qbp_checked, SPEC_CONTROL, profile=False)
    bitplane_small = phase("check bitplane", agree_bitplane, dev)
    cheb = phase("cheb", cheb_path, dev, gisette)
    optimal = phase("optimal", optimal_path, dev)
    serve_opt = phase("serve-optimal", serve_optimal, dev)
    cheb_small = phase("check cheb and optimal", agree_cheb, dev)
    act = phase("act-quant", act_quant_path, dev)
    embed_run = phase("serve-embed", serve_embed, dev, runs[8], checked)
    embed_small = phase("check embed and act-quant", agree_embed_act, dev)
    mamba = phase("serve-mamba", serve_ssm, dev, ssd_rows, mamba_qmm_rows)
    mamba_small = phase("check mamba", agree_mamba, dev)
    # slice 8: every qmm launch of [serve-dense] and [serve-legacy-dense]
    # must be at a shape checked for it
    dense_checked = {r["key"] for r in dense_qmm_rows}
    dense = phase("serve-dense", serve_dense, dev, dense_checked)
    legacy_dense = phase("serve-legacy-dense", serve_legacy_dense, dev, dense_checked)
    dense_small = phase("check dense", agree_dense, dev)
    # slice 9: every ssd_chunk_scan and qmm launch of [serve-hybrid] must
    # be at a shape checked for it
    hybrid = phase("serve-hybrid", serve_ssm, dev, hybrid_ssd_rows, hybrid_qmm_rows,
                   "zamba2-2.7b")
    hybrid_small = phase("check hybrid", agree_hybrid, dev)
    # slice 10: every qmm launch of [serve-moe] and [serve-legacy-moe] must
    # be at a shape checked for it
    moe_checked = {r["key"] for r in moe_qmm_rows}
    moe = phase("serve-moe", serve_moe, dev, moe_checked)
    legacy_moe = phase("serve-legacy-moe", serve_legacy_moe, dev, moe_checked)
    moe_small = phase("check moe", agree_moe, dev)
    # slice 11: every qmm launch of [serve-mixtral] must be at a shape
    # checked for it; [check window] takes the int8 build's attention blocks
    mixtral, window_blocks = phase("serve-mixtral", serve_mixtral, dev,
                                   {r["key"] for r in mixtral_qmm_rows})
    window = phase("check window", check_window, dev, window_blocks)
    del window_blocks
    torch.cuda.empty_cache()
    mixtral_small = phase("check mixtral", agree_mixtral, dev)
    # slice 12: every qmm launch of [serve-vlm] and [serve-audio] must be at
    # a shape checked for it; [check cross] takes the int8 build's cross
    # blocks and the vision stand-ins
    vlm, cross_blocks, vision = phase("serve-vlm", serve_vlm, dev,
                                      {r["key"] for r in vlm_qmm_rows})
    cross = phase("check cross", check_cross, dev, cross_blocks, vision)
    del cross_blocks, vision
    torch.cuda.empty_cache()
    vlm_small = phase("check vlm", agree_vlm, dev)
    audio = phase("serve-audio", serve_audio, dev, {r["key"] for r in audio_qmm_rows})
    audio_small = phase("check audio", agree_audio, dev)
    # slice 13: every qmm launch of [serve-features] must be at a shape
    # checked for gemma-2b or for it
    features, feat_acc = phase("serve-features", serve_features, dev,
                               checked | {r["key"] for r in feat_qmm_rows})
    features_small = phase("check serve-features", agree_features, dev)

    # threefry launches on the main paths: the phases' reads (tf_path), and
    # the runs whose counters are reset again before a later run of the
    # same phase: [train]'s all8 (before the yardstick) and [linear]'s e2e
    # (before fp32). Every (out, keys, n) they launched gets a row: the
    # TF_ROWS rows above, and the rest checked bit-exact and timed here
    e2e = linear["runs"]["e2e"]
    for out_, k, n, c in (*training["runs"]["all8"]["shape_launches"]["threefry"],
                          *e2e["threefry_shape_launches"]):
        tf_path[(out_, k, n)] += c
    rest = sorted(set(tf_path) - {r["key"] for r in tf_rows})
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    tf_rows += phase("kernel threefry path shapes", threefry_rows, dev, flush,
                     [(out_, k, (n,)) for out_, k, n in rest])
    del flush
    torch.cuda.empty_cache()
    unchecked = set(tf_path) - {r["key"] for r in tf_rows}
    if unchecked:
        raise AssertionError(f"threefry launched at unchecked shapes {sorted(unchecked)}")

    kernels = []
    all8 = {name: {tuple(k[:-1]): k[-1] for k in rows} for name, rows in
            training["runs"]["all8"]["shape_launches"].items()}
    # qmm launches on gemma-2b's paths: [train]'s all8 run, [serve] at the
    # row's bits and, for int8, [serve-embed]
    embed_qmm = {tuple(k[:-1]): k[-1] for k in embed_run["qmm_shape_launches"]}
    for r in qmm_rows:
        key = r.pop("key")
        r["launches"] = (all8["qmm"].get(key, 0) + runs[4 if key[0] else 8][1].get(key, 0)
                         + (0 if key[0] else embed_qmm.get(key, 0))
                         + feat_acc["qmm"].get(key, 0))
        kernels.append({"name": r.pop("name"), "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/qmm.cu",
                        "replaces": "src/repro/kernels/qmm.py:158", **r})
    for r in attn_rows:
        bits, path, layout = r.pop("kv_bits"), r.pop("path"), r.pop("layout")
        if layout in ATTN_DENSE_LAYOUTS:
            # [serve-dense]'s runs of the model with this head layout at kv bits
            r["launches"] = sum(run[0]["paged_decode_attn"] for run in dense.values()
                                if tuple(run[2]["attn_layout"]) == layout
                                and run[2]["kv_bits"] == bits)
            kernels.append({"name": r.pop("name"), "route": "cuda",
                            "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
                            "replaces": "src/repro/kernels/paged_attn.py:195", **r})
            continue
        # kv 8: [serve] at 8/8 and [serve-optimal]; the check-only rows 0
        r["launches"] = runs[bits][0]["paged_decode_attn"] if path and bits in runs else 0
        if path and bits == 8:
            r["launches"] += serve_opt["launches"]["paged_decode_attn"]
        if path and bits == FEAT_BITS:      # [serve-features]' decode steps
            r["launches"] += feat_acc["attn_decode"]
        kernels.append({"name": r.pop("name"), "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
                        "replaces": "src/repro/kernels/paged_attn.py:195", **r})
    # ds_quant and qmv launches on their paths: the wrappers' shape counters,
    # reset just before and read just after slice 2's e2e run (column
    # scales), [quantize-rows] (ds_quantize(scale=None): row scales) and
    # [optimal]'s uniform runs (column scales)
    ds_path, qmv_path = collections.Counter(), collections.Counter()
    for shp, axis in ((e2e["ds_shape_launches"], "col"), (qrows["shape_launches"], "row"),
                      (optimal["ds_shape_launches"], "col")):
        for kname, rr, cc, n in shp:
            if kname in ("ds_quant", "ds_quant_keyed"):
                ds_path[(rr, cc, axis, kname == "ds_quant_keyed")] += n
    for shp in (e2e["qmv_shape_launches"], optimal["qmv_shape_launches"]):
        for rr, cc, cols, n in shp:
            qmv_path[(rr, cc, cols)] += n
    unchecked = (set(ds_path) - {r["key"] for r in ds_rows}) | \
        (set(qmv_path) - {r["key"] for r in qmv_rows})
    if unchecked:
        raise AssertionError(f"ds_quant / qmv launched at unchecked shapes {sorted(unchecked)}")
    for r in tf_rows:
        r["launches"] = tf_path[r.pop("key")]
        kernels.append({"name": r.pop("name"), "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/threefry.cu",
                        "replaces": "none: jax.random.bits/uniform (XLA threefry2x32, "
                                    "no pallas_call)", **r})
    for r in ds_rows:
        r["launches"] = ds_path[r.pop("key")]
        kernels.append({"name": r.pop("name"), "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/ds_quant.cu",
                        "replaces": "src/repro/kernels/stoch_quant.py:124", **r})
    for r in qmv_rows:
        r["launches"] = qmv_path[r.pop("key")]
        kernels.append({"name": r.pop("name"), "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/qmv.cu",
                        "replaces": "src/repro/kernels/qmm.py:120", **r})
    for r in qmm_t_rows:
        r["launches"] = all8["qmm_t"].get(r.pop("key"), 0)
        kernels.append({"name": r.pop("name"), "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/qmm_t.cu",
                        "replaces": "src/repro/kernels/qmm.py:199", **r})
    for r in adamw_rows:
        name, rr, cc = r.pop("key")
        r["launches"] = all8["quant_adamw"].get((name[len("qadamw_"):], rr, cc), 0)
        line = 164 if name.startswith("qadamw_update") else 138
        kernels.append({"name": r.pop("name"), "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/quant_adamw.cu",
                        "replaces": f"src/repro/kernels/quant_adamw.py:{line}", **r})
    # qmm_bitplane launches on slice 4's path: the wrapper's (P, M, K, N)
    # counter, reset just before each run, summed over [serve-bitplane] at
    # 8 and 4 bits and [spec]
    path = collections.Counter()
    for shp in (bitplane[8]["shape_launches"], bitplane[4]["shape_launches"],
                spec["shape_launches"]):
        for p, m, k, n, c in shp:
            path[(p, m, k, n)] += c
    for r in qbp_rows:
        r["launches"] = path[r.pop("key")]
        kernels.append({"name": r.pop("name"), "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/qmm_bitplane.cu",
                        "replaces": "src/repro/kernels/qmm_bitplane.py:80", **r})
    # row_absmax / stoch_quant launches on [quantize-rows]: the wrapper's
    # (kernel, R, C) counter, f32 rows only (the path quantizes f32)
    q_shapes = {tuple(k[:3]): k[3] for k in qrows["shape_launches"]}
    for rows_, kname, line in ((absmax_rows, "row_absmax", 159), (sq_rows, "stoch_quant", 64)):
        for r in rows_:
            key = r.pop("key")
            r["launches"] = q_shapes.get((kname, *key), 0) if key else 0
            kernels.append({"name": r.pop("name"), "route": "cuda",
                            "source": "src/repro_torch/kernels/csrc/stoch_quant.cu",
                            "replaces": f"src/repro/kernels/stoch_quant.py:{line}", **r})
    # qmm_qout launches on [act-quant]'s path and qmm_t's at the tied
    # unembed on [serve-embed]'s: the wrappers' (packed, M, K, N) counters,
    # reset just before each run; every launched shape must have been checked
    act_path = {tuple(k[:-1]): k[-1] for k in act["shape_launches"]}
    unembed_path = {tuple(k[:-1]): k[-1] for k in embed_run["qmm_t_shape_launches"]}
    unchecked = (set(act_path) - {r["key"] for r in qout_rows}) | \
        (set(unembed_path) - {r["key"] for r in unembed_rows})
    if unchecked:
        raise AssertionError(f"qmm_qout / qmm_t launched at unchecked shapes {sorted(unchecked)}")
    for r in qout_rows:
        r["launches"] = act_path.get(r.pop("key"), 0)
        kernels.append({"name": r.pop("name"), "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/qmm_qout.cu",
                        "replaces": "src/repro/kernels/qmm.py:284", **r})
    for r in unembed_rows:
        r["launches"] = unembed_path.get(r.pop("key"), 0)
        kernels.append({"name": r.pop("name"), "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/qmm_t.cu",
                        "replaces": "src/repro/kernels/qmm.py:199", **r})
    # ssd_chunk_scan and qmm at mamba2's shapes on [serve-mamba]'s main
    # path: the wrappers' shape counters, reset just before and read just
    # after each serve() call, summed (the consistency checks' launches are
    # in the report's "check_shape_launches")
    # (and [serve-hybrid]'s at zamba2's, slice 9)
    ssd_errors = {r["name"]: {"y": r.pop("y_err"), "state": r.pop("state_err")}
                  for r in (*ssd_rows, *hybrid_ssd_rows)}
    for run, ssd_rows_, qmm_rows_ in ((mamba, ssd_rows, mamba_qmm_rows),
                                      (hybrid, hybrid_ssd_rows, hybrid_qmm_rows)):
        run_path = {name: {tuple(k[:-1]): k[-1] for k in rows}
                    for name, rows in run["shape_launches"].items()}
        for r in ssd_rows_:
            r["launches"] = run_path["ssd_chunk_scan"].get(r.pop("key"), 0)
            kernels.append({"name": r.pop("name"), "route": "cuda",
                            "source": "src/repro_torch/kernels/csrc/ssd.cu",
                            "replaces": "src/repro/kernels/ssd.py:69", **r})
        for r in qmm_rows_:
            r["launches"] = run_path["qmm"].get(r.pop("key"), 0)
            kernels.append({"name": r.pop("name"), "route": "cuda",
                            "source": "src/repro_torch/kernels/csrc/qmm.cu",
                            "replaces": "src/repro/kernels/qmm.py:158", **r})
    # qmm at slice 8's shapes: [serve-dense]'s four runs and
    # [serve-legacy-dense]'s serve() call, by (packed, M, K, N)
    dense_path = collections.Counter()
    for run in dense.values():
        dense_path.update(run[1])
    dense_path.update({tuple(k[:-1]): k[-1] for k in legacy_dense["qmm_shape_launches"]})
    for r in dense_qmm_rows:
        r["launches"] = dense_path.get(r.pop("key"), 0)
        kernels.append({"name": r.pop("name"), "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/qmm.cu",
                        "replaces": "src/repro/kernels/qmm.py:158", **r})
    # qmm at slice 10's shapes: [serve-moe]'s two runs and
    # [serve-legacy-moe]'s serve() call, by (packed, M, K, N); B10 at
    # granite-moe's layout: [serve-moe]'s run at the row's KV bits
    moe_path = collections.Counter()
    for run in moe.values():
        moe_path.update(run[1])
    moe_path.update({tuple(k[:-1]): k[-1] for k in legacy_moe["qmm_shape_launches"]})
    for r in moe_qmm_rows:
        r["launches"] = moe_path.get(r.pop("key"), 0)
        kernels.append({"name": r.pop("name"), "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/qmm.cu",
                        "replaces": "src/repro/kernels/qmm.py:158", **r})
    # qmm at slice 11's shapes: [serve-mixtral]'s serve() calls at 8/8 and
    # 4/4, by (packed, M, K, N)
    mixtral_path = collections.Counter()
    for run in mixtral.values():
        mixtral_path.update({tuple(k[:-1]): k[-1] for k in run["qmm_shape_launches"]})
    for r in mixtral_qmm_rows:
        r["launches"] = mixtral_path.get(r.pop("key"), 0)
        kernels.append({"name": r.pop("name"), "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/qmm.cu",
                        "replaces": "src/repro/kernels/qmm.py:158", **r})
    # qmm at slice 12's shapes: [serve-vlm]'s prefill and decode steps at
    # 8/8 and 4/4, [serve-audio]'s two serve_engine calls, by (packed, M, K,
    # N); B10 at granite-moe's and musicgen's layouts: [serve-moe]'s and
    # [serve-audio]'s runs at the row's KV bits
    vlm_path, audio_path = collections.Counter(), collections.Counter()
    for run in vlm.values():
        vlm_path.update({tuple(k[:-1]): k[-1] for k in run["qmm_shape_launches"]})
    for run in audio.values():
        audio_path.update(run[1])
    for rows_, path_ in ((vlm_qmm_rows, vlm_path), (audio_qmm_rows, audio_path)):
        for r in rows_:
            r["launches"] = path_.get(r.pop("key"), 0)
            kernels.append({"name": r.pop("name"), "route": "cuda",
                            "source": "src/repro_torch/kernels/csrc/qmm.cu",
                            "replaces": "src/repro/kernels/qmm.py:158", **r})
    for rows_, runs_ in ((moe_attn_rows, moe), (audio_attn_rows, audio)):
        for r in rows_:
            bits = r.pop("kv_bits")
            r.pop("path"), r.pop("layout")
            r["launches"] = sum(run[0]["paged_decode_attn"] for run in runs_.values()
                                if run[2]["kv_bits"] == bits)
            kernels.append({"name": r.pop("name"), "route": "cuda",
                            "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
                            "replaces": "src/repro/kernels/paged_attn.py:195", **r})
    # slice 13: qmm at [serve-features]' new M (the prefill chunk, the
    # shared-prefix buckets) and B10 at its chunk call, from the phase's
    # counters summed over its five runs
    for r in feat_qmm_rows:
        r["launches"] = feat_acc["qmm"].get(r.pop("key"), 0)
        kernels.append({"name": r.pop("name"), "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/qmm.cu",
                        "replaces": "src/repro/kernels/qmm.py:158", **r})
    for r in feat_attn_rows:
        r.pop("kv_bits"), r.pop("layout")
        r["launches"] = feat_acc["attn_chunk"] if r.pop("path") else 0
        kernels.append({"name": r.pop("name"), "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
                        "replaces": "src/repro/kernels/paged_attn.py:195", **r})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "core")
    extra_keys = ("matmul_ms", "plain_code_share", "exact_code_share", "before_ms",
                  "parity_then_host_ms")
    extra = {r["name"]: {k: r[k] for k in extra_keys if k in r}
             for r in kernels if any(k in r for k in extra_keys)}
    kernels = [{k: r[k] for k in keys if k in r} for r in kernels]

    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    report = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_seconds": build_s, "kernels": kernels,
              "serve": [runs[b][2] for b in (8, 4)], "small_agreement": small,
              "linear": linear, "linear_agreement": linear_small,
              "train": training, "train_agreement": train_small,
              "serve_bitplane": bitplane, "spec": spec, "bitplane_rows": qbp_same_rows,
              "bitplane_agreement": bitplane_small, "quantize_rows": qrows, "cheb": cheb,
              "optimal": optimal, "serve_optimal": serve_opt, "cheb_agreement": cheb_small,
              "kernel_extra": extra, "act_quant": act, "serve_embed": embed_run,
              "embed_act_agreement": embed_small, "serve_mamba": mamba,
              "mamba_agreement": mamba_small, "ssd_errors": ssd_errors,
              "serve_dense": {k: v[2] for k, v in dense.items()},
              "serve_legacy_dense": legacy_dense, "dense_agreement": dense_small,
              "serve_hybrid": hybrid, "hybrid_agreement": hybrid_small,
              "serve_moe": {k: v[2] for k, v in moe.items()},
              "serve_legacy_moe": legacy_moe, "moe_agreement": moe_small,
              "serve_mixtral": mixtral, "window_check": window,
              "mixtral_agreement": mixtral_small,
              "serve_vlm": vlm, "cross_check": cross, "vlm_agreement": vlm_small,
              "serve_audio": {k: v[2] for k, v in audio.items()},
              "audio_agreement": audio_small, "serve_features": features,
              "features_agreement": features_small,
              "threefry_path_launches": [[*k, n] for k, n in sorted(tf_path.items())],
              "int32_ops_per_s": INT32_OPS, "phase_seconds": phase_s}
    (out_dir / "chip_smoke_report.json").write_text(json.dumps(report, indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
