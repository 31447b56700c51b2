"""Serving launcher of the port — a thin CLI over the continuous-batching
engine (port of ``repro.launch.serve``: the legacy ``serve``,
``make_trace``, single-replica ``serve_engine`` and ``main``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --device cpu --requests 4

serves a mixed-length synthetic trace at the reduced size on the CPU; on
the card (the default device) ``--no-reduced`` serves full-width gemma-2b
with random weights:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --no-reduced --weight-bits 8 --kv-bits 8 --page-size 16 \
      --max-prompt 128 --max-new 32 --requests 8

Bitplane weights serve any precision from one artifact, and
self-speculative decoding drafts through their low-bit view (the output is
token-identical to vanilla decode):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --device cpu --weight-bits 8 --kv-bits 8 --weight-layout bitplane \
      --spec-decode 3 --draft-bits 4

``--optimal-levels`` stores the weights on variance-optimal level tables
(§3.3; ``--weight-bits 8`` gives 255 levels per weight):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --device cpu --requests 4 --weight-bits 8 --kv-bits 8 --optimal-levels

Legacy single-shot mode (``serve``: one fixed random prompt batch, prefill,
then greedy decode) serves every ported family. A dense model decodes on a
ring-buffer KV cache of prompt + gen rows, attending in plain PyTorch as the
reference does; mamba2-780m's prefill runs the SSD kernel, its decode the
O(1) recurrence on the (conv, ssm) cache, which the paged engine does not
take; the hybrid zamba2-2.7b runs both — its Mamba2 layers as mamba2's, its
shared attention block (after every 9 layers) on one ring KV cache of
prompt + gen rows per application, at ``--kv-bits``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \
      --device cpu --legacy --kv-bits 8 --weight-bits 8 --batch 2 \
      --prompt-len 16 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
      --device cpu --legacy --batch 2 --prompt-len 16 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
      --legacy --no-reduced --weight-bits 8 --batch 4 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --device cpu --legacy --kv-bits 8 --weight-bits 8 --batch 2 \
      --prompt-len 16 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --legacy --no-reduced --kv-bits 8 --weight-bits 8 --batch 4 \
      --prompt-len 1024 --gen 32

The moe granite-moe-3b-a800m serves through both: the paged engine, whose
steps take the MoE block's dense path (every expert on every token), and
the legacy loop, whose prefill above 512 tokens takes the
capacity-bounded dispatch; every stacked expert weight runs one ``qmm``
launch per expert slice on the card:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \
      --device cpu --requests 4 --weight-bits 8 --kv-bits 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \
      --device cpu --legacy --weight-bits 8 --kv-bits 8 --batch 2 \
      --prompt-len 300 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \
      --no-reduced --weight-bits 8 --kv-bits 8 --page-size 16 \
      --max-prompt 128 --max-new 32 --requests 8

mixtral-8x7b (8 experts, top 2, sliding window 4096) serves through the
legacy loop alone — the paged engine rejects windows, as the reference's
does: each layer's ring cache keeps the prompt's last ``window`` rows and
decode writes at ``length % window``, which holds the window only where
the prompt is longer than the window and a multiple of it (ROADMAP C24).
Its 46.6 B parameters fit the card only as int codes; every weight is
encoded a layer at a time as it is drawn:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --device cpu --legacy --weight-bits 8 --kv-bits 8 --batch 2 \
      --prompt-len 64 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --legacy --no-reduced --weight-bits 8 --kv-bits 8 --batch 2 \
      --prompt-len 8192 --gen 32

llama-3.2-vision-11b (a cross-attention block over 4096 vision tokens
after every 5 of its 40 layers) serves through the legacy loop alone, as
in the reference, whose loop feeds it zero vision tokens (ROADMAP C25):
its cross K/V are cached raw in the compute dtype whatever ``--kv-bits``.
musicgen-medium (the audio family: the dense layer with a gelu MLP)
serves through both:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-3.2-vision-11b \
      --device cpu --legacy --weight-bits 8 --kv-bits 8 --batch 2 \
      --prompt-len 16 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-medium \
      --device cpu --requests 4

Multi-replica serving, prefix caching, chunked prefill and sampling wait
for ROADMAP A3.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs, prng, resolve_device
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import transformer as T
from repro_torch.precision.qat import quantize_param_tree, quantizing_store
from repro_torch.quant import PrecisionPlan


def _resolve_plan(plan, kv_bits, weight_bits, optimal_levels=False) -> PrecisionPlan:
    if plan is None:
        plan = PrecisionPlan(kv_bits=kv_bits, model_bits=weight_bits,
                             model_storage="int" if weight_bits else "fake",
                             optimal_levels=optimal_levels)
    if plan.model_bits and plan.model_storage != "int":
        plan = dataclasses.replace(plan, model_storage="int")
    return plan


def _build(arch: str, *, reduced: bool, plan: PrecisionPlan, seed: int, device,
           weight_layout: str = "dense"):
    """The config and random weights from ``seed``. Int and bitplane
    weights are encoded a layer at a time as they are drawn
    (``quantizing_store``), so the compute-dtype tree never exists whole;
    variance-optimal level tables fit each whole leaf, so that build draws
    the tree first."""
    get = configs.get_reduced if reduced else configs.get_config
    cfg = get(arch, precision=plan)
    optimal = plan.optimal_levels and weight_layout == "dense"
    if plan.model_bits and not optimal:
        store = quantizing_store(plan.model_bits, layout=weight_layout)
        return cfg, T.init_params(cfg, seed=seed, device=device, weight=store)
    params = T.init_params(cfg, seed=seed, device=device)
    if plan.model_bits:
        params = quantize_param_tree(params, bits=plan.model_bits, optimal=True)
    return cfg, params


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, *, reduced: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, kv_bits: int = 0,
          weight_bits: int = 0, optimal_levels: bool = False, seed: int = 0,
          plan: PrecisionPlan | None = None, device=None):
    """Legacy single-shot serve on ``device`` (default ``cuda``): greedy-decode
    ``gen`` tokens for one random fixed-length prompt batch (the reference's
    ``randint(fold_in(PRNGKey(seed), 1))`` draw) with random weights from
    ``seed``. A warm-up decode step runs and is thrown away before the
    clock starts (``decode_step`` never writes into the state it is given).
    Returns (tokens (B, prompt+gen) numpy int32, steady-state tokens/s over
    the ``gen − 1`` timed steps; NaN when ``gen`` is 1).

    A dense, moe, audio or vlm model's ring cache, and each of a hybrid
    model's shared caches, holds ``prompt_len + gen`` rows, as the
    reference's; a sliding-window model's the last ``window`` prompt rows
    where the prompt is longer than the window. A vlm model attends zero
    vision tokens, as the reference's loop feeds it, so its cross blocks
    add exactly 0 (ROADMAP C25)."""
    dev = resolve_device(device)
    plan = _resolve_plan(plan, kv_bits, weight_bits, optimal_levels)
    cfg, params = _build(arch, reduced=reduced, plan=plan, seed=seed, device=dev)
    prompts = prng.randint(prng.fold_in(prng.PRNGKey(seed), 1), (batch, prompt_len),
                           0, cfg.vocab_size, device=dev)
    inputs = {"tokens": prompts}
    if cfg.family == "vlm":
        # the reference's legacy loop feeds zero vision tokens: every cross
        # k and v is then 0 and every cross block adds exactly 0 (ROADMAP C25)
        inputs["vision"] = torch.zeros((batch, cfg.n_vis_tokens, cfg.d_model),
                                       dtype=torch.float32, device=dev)
    logits, state = make_prefill_step(cfg, pad_to=prompt_len + gen)(params, inputs)
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    step_fn = make_serve_step(cfg)
    step_fn(params, state, next_tok)                    # warm-up, thrown away
    _sync(dev)

    out = [prompts, next_tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        _, nxt, state = step_fn(params, state, out[-1])
        out.append(nxt[:, None])
    tokens = torch.cat(out, dim=1)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    tps = batch * (gen - 1) / decode_s if gen > 1 else float("nan")
    return tokens.cpu().numpy(), tps


def make_trace(n_requests: int, vocab_size: int, *, max_new: int = 16,
               min_prompt: int = 4, max_prompt: int = 32, seed: int = 0,
               temperature: float = 0.0, top_k: int = 0):
    """A mixed-length synthetic request trace — the same numpy draws as the
    reference, so both engines serve identical requests."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n_requests):
        s = int(rng.integers(min_prompt, max_prompt + 1))
        g = int(rng.integers(max(1, max_new // 4), max_new + 1))
        reqs.append(Request(
            rid=rid, prompt=rng.integers(0, vocab_size, s),
            max_new_tokens=g, temperature=temperature, top_k=top_k, seed=seed))
    return reqs


def serve_engine(arch: str, *, reduced: bool = True, n_requests: int = 16,
                 max_new: int = 16, min_prompt: int = 4, max_prompt: int = 32,
                 kv_bits: int = 0, weight_bits: int = 0, seed: int = 0,
                 plan: PrecisionPlan | None = None, max_slots: int = 4,
                 page_size: int = 8, temperature: float = 0.0, top_k: int = 0,
                 backend: str | None = None, device=None, replicas: int = 1,
                 weight_layout: str = "dense", autoscale: bool = False,
                 slo_admit_ms: float | None = None, prefix_cache: bool = False,
                 chunk_pages: int | None = None, spec_decode: int = 0,
                 draft_bits: int | None = None, ship_dir: str | None = None,
                 optimal_levels: bool = False):
    """Serve a mixed-length trace through one engine on ``device`` (default
    ``cuda``) with random weights from ``seed``. Returns (engine, results
    dict rid → Finished).

    ``weight_layout='bitplane'`` stores the weights bit-serially (one
    artifact, any precision); ``autoscale=True`` then attaches a
    :class:`~repro_torch.serve.PrecisionAutoscaler` (SLO ``slo_admit_ms``,
    default ``$ZIPML_SLO_ADMIT_MS`` or 50 ms) over the bits ladder 8 → 4 →
    2 → 1 cut at ``weight_bits``; ``spec_decode=k, draft_bits=b`` turns on
    self-speculative decoding through the b-bit view; ``ship_dir`` writes
    the bitplane weights as a ``weights-bitplane-v1`` artifact there and
    serves from the artifact loaded back. The last three need
    ``weight_layout='bitplane'`` with ``weight_bits > 0``.
    ``optimal_levels=True`` stores the dense weights on variance-optimal
    level tables (§3.3), served through the decode fallback. ``plan``,
    when given, overrides ``kv_bits``, ``weight_bits`` and
    ``optimal_levels``."""
    from repro_torch.ckpt import load_ship_weights, save_ship_weights
    from repro_torch.serve import AutoscalerConfig, PrecisionAutoscaler, ServeEngine

    if replicas != 1:
        raise NotImplementedError("ReplicaSet (replicas > 1) is not in the port "
                                  "yet (ROADMAP A3)")
    dev = resolve_device(device)
    plan = _resolve_plan(plan, kv_bits, weight_bits, optimal_levels)
    bitplane = weight_layout == "bitplane" and plan.model_bits
    if spec_decode and not bitplane:
        raise ValueError(
            "spec_decode needs --weight-layout bitplane with weight_bits > 0 "
            "(the draft is a slice_planes view of the served artifact)")
    if ship_dir is not None and not bitplane:
        raise ValueError("ship_dir needs --weight-layout bitplane with weight_bits > 0")
    if autoscale and not bitplane:
        raise ValueError("autoscale needs --weight-layout bitplane with weight_bits > 0")
    cfg, params = _build(arch, reduced=reduced, plan=plan, seed=seed, device=dev,
                         weight_layout=weight_layout)
    if ship_dir is not None:
        save_ship_weights(ship_dir, params)
        del params
        params = load_ship_weights(ship_dir, bits=plan.model_bits, device=dev)
    autoscaler = None
    if autoscale:
        over = {} if slo_admit_ms is None else {"slo_admit_ms": slo_admit_ms}
        ladder = tuple(b for b in (8, 4, 2, 1) if b <= plan.model_bits)
        autoscaler = PrecisionAutoscaler(AutoscalerConfig.from_env(bits_ladder=ladder,
                                                                   **over))
    engine = ServeEngine(params, cfg, plan=plan, max_slots=max_slots,
                         page_size=page_size,
                         max_seq_len=max_prompt + max_new + page_size,
                         backend=backend, device=dev, autoscaler=autoscaler,
                         prefix_cache=prefix_cache,
                         chunk_pages=chunk_pages, spec_decode=spec_decode,
                         draft_bits=draft_bits)
    trace = make_trace(n_requests, cfg.vocab_size, max_new=max_new,
                       min_prompt=min_prompt, max_prompt=max_prompt, seed=seed,
                       temperature=temperature, top_k=top_k)
    return engine, engine.run(trace)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True, help="--no-reduced serves full width")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    ap.add_argument("--kv-bits", type=int, default=0, choices=(0, 4, 8))
    ap.add_argument("--weight-bits", type=int, default=0,
                    help="0, 4 or 8 (dense layout); 1..8 with --weight-layout bitplane")
    ap.add_argument("--weight-layout", default="dense", choices=("dense", "bitplane"),
                    help="bitplane = bit-serial any-precision weight storage")
    ap.add_argument("--spec-decode", type=int, default=0, metavar="K",
                    help="speculative decoding: draft K tokens per slot through "
                         "the low-bit weight view, verify in one full-precision "
                         "step (needs bitplane layout)")
    ap.add_argument("--draft-bits", type=int, default=None,
                    help="weight bits of the speculative draft view (below the "
                         "serving bits)")
    ap.add_argument("--optimal-levels", action="store_true",
                    help="store the weights on variance-optimal level tables "
                         "(dense layout)")
    ap.add_argument("--autoscale", action="store_true",
                    help="adapt weight bits to load (needs bitplane layout)")
    ap.add_argument("--slo-admit-ms", type=float, default=None,
                    help="admission-latency SLO for --autoscale "
                         "(default $ZIPML_SLO_ADMIT_MS or 50)")
    ap.add_argument("--kernel-backend", default=None, choices=(None, "ref", "cuda"))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--min-prompt", type=int, default=4)
    ap.add_argument("--max-prompt", type=int, default=32)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    # legacy single-shot mode
    ap.add_argument("--legacy", action="store_true",
                    help="fixed-batch greedy loop (ring KV cache, the ssm "
                         "recurrent cache, or the hybrid's both)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    args = ap.parse_args(argv)
    allowed = range(1, 9) if args.weight_layout == "bitplane" else (4, 8)
    if args.weight_bits and args.weight_bits not in allowed:
        ap.error(f"--weight-bits {args.weight_bits} is not servable with "
                 f"--weight-layout {args.weight_layout} (allowed: 0, "
                 f"{', '.join(map(str, allowed))})")

    if args.legacy:
        tokens, tps = serve(args.arch, reduced=args.reduced, batch=args.batch,
                            prompt_len=args.prompt_len, gen=args.gen,
                            kv_bits=args.kv_bits, weight_bits=args.weight_bits,
                            optimal_levels=args.optimal_levels, seed=args.seed,
                            device=args.device)
        print(f"[serve] generated {tokens.shape} tokens at {tps:.1f} tok/s "
              f"steady-state (kv_bits={args.kv_bits}, "
              f"weight_bits={args.weight_bits}) on {args.device}")
        return

    engine, results = serve_engine(
        args.arch, reduced=args.reduced, n_requests=args.requests,
        max_new=args.max_new, min_prompt=args.min_prompt,
        max_prompt=args.max_prompt, kv_bits=args.kv_bits,
        weight_bits=args.weight_bits, seed=args.seed, max_slots=args.max_slots,
        page_size=args.page_size, backend=args.kernel_backend, device=args.device,
        weight_layout=args.weight_layout, autoscale=args.autoscale,
        slo_admit_ms=args.slo_admit_ms, spec_decode=args.spec_decode,
        draft_bits=args.draft_bits, optimal_levels=args.optimal_levels)
    st = engine.stats
    gen_total = sum(f.n_generated for f in results.values())
    print(f"[serve-engine] {len(results)} requests, {gen_total} tokens "
          f"generated in {st['decode_steps']} decode steps "
          f"(+{st['prefill_tokens']} prefill tokens) on {engine.device}")
    print(f"[serve-engine] steady-state decode: {engine.throughput():.1f} tok/s")
    print(f"[serve-engine] KV pool: {engine.kv_pool_nbytes():,} bytes "
          f"(kv_bits={args.kv_bits or 'bf16'}, page_size={args.page_size}) "
          f"via QTensor.nbytes")
    print(f"[serve-engine] weights: {engine.weight_nbytes():,} bytes "
          f"(layout={args.weight_layout}, served bits "
          f"{engine.weight_bits or args.weight_bits or 'bf16'})")
    if args.spec_decode:
        print(f"[serve-engine] speculative: {st['spec_steps']} windows, acceptance "
              f"{engine.acceptance_rate():.2f} (k={args.spec_decode}, "
              f"draft_bits={args.draft_bits})")
    if engine.autoscaler is not None:
        asc = engine.autoscaler
        print(f"[serve-engine] autoscaler: bits={asc.bits} after "
              f"{asc.n_observations} observations, {asc.n_moves} moves "
              f"(slo_admit_ms={asc.config.slo_admit_ms})")


if __name__ == "__main__":
    main()
