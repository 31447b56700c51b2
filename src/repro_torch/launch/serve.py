"""Serving launcher of the port — a thin CLI over the continuous-batching
engine (port of ``repro.launch.serve``: ``make_trace``, single-replica
``serve_engine`` and ``main``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --device cpu --requests 4

serves a mixed-length synthetic trace at the reduced size on the CPU; on
the card (the default device) ``--no-reduced`` serves full-width gemma-2b
with random weights:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --no-reduced --weight-bits 8 --kv-bits 8 --page-size 16 \
      --max-prompt 128 --max-new 32 --requests 8

Multi-replica serving, speculative decoding, prefix caching, chunked
prefill, autoscaling and sampling wait for ROADMAP A8/A9.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch import configs, resolve_device
from repro_torch.models import transformer as T
from repro_torch.precision.qat import quantize_param_tree
from repro_torch.quant import PrecisionPlan


def _resolve_plan(plan, kv_bits, weight_bits) -> PrecisionPlan:
    if plan is None:
        plan = PrecisionPlan(kv_bits=kv_bits, model_bits=weight_bits,
                             model_storage="int" if weight_bits else "fake")
    if plan.model_bits and plan.model_storage != "int":
        plan = dataclasses.replace(plan, model_storage="int")
    return plan


def _build(arch: str, *, reduced: bool, plan: PrecisionPlan, seed: int, device):
    get = configs.get_reduced if reduced else configs.get_config
    cfg = get(arch, precision=plan)
    params = T.init_params(cfg, seed=seed, device=device)
    if plan.model_bits:
        params = quantize_param_tree(params, bits=plan.model_bits)
    return cfg, params


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
                 backend: str | None = None, device=None, replicas: int = 1, weight_layout: str = "dense",
                 prefix_cache: bool = False, chunk_pages: int | None = None,
                 spec_decode: int = 0, autoscale: bool = False):
    """Serve a mixed-length trace through one engine on ``device`` (default
    ``cuda``) with random weights from ``seed``. Returns (engine, results
    dict rid → Finished)."""
    from repro_torch.serve import ServeEngine

    if replicas != 1 or weight_layout != "dense" or autoscale:
        raise NotImplementedError("ReplicaSet / bitplane weights / autoscaling "
                                  "are not in slice 1 (ROADMAP A8, A9)")
    dev = resolve_device(device)
    plan = _resolve_plan(plan, kv_bits, weight_bits)
    cfg, params = _build(arch, reduced=reduced, plan=plan, seed=seed, device=dev)
    engine = ServeEngine(params, cfg, plan=plan, max_slots=max_slots,
                         page_size=page_size,
                         max_seq_len=max_prompt + max_new + page_size,
                         backend=backend, device=dev, prefix_cache=prefix_cache,
                         chunk_pages=chunk_pages, spec_decode=spec_decode)
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
    ap.add_argument("--weight-bits", type=int, default=0, choices=(0, 4, 8))
    ap.add_argument("--kernel-backend", default=None, choices=(None, "ref", "cuda"))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--min-prompt", type=int, default=4)
    ap.add_argument("--max-prompt", type=int, default=32)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    engine, results = serve_engine(
        args.arch, reduced=args.reduced, n_requests=args.requests,
        max_new=args.max_new, min_prompt=args.min_prompt,
        max_prompt=args.max_prompt, kv_bits=args.kv_bits,
        weight_bits=args.weight_bits, seed=args.seed, max_slots=args.max_slots,
        page_size=args.page_size, backend=args.kernel_backend, device=args.device)
    st = engine.stats
    gen_total = sum(f.n_generated for f in results.values())
    print(f"[serve-engine] {len(results)} requests, {gen_total} tokens "
          f"generated in {st['decode_steps']} decode steps "
          f"(+{st['prefill_tokens']} prefill tokens) on {engine.device}")
    print(f"[serve-engine] steady-state decode: {engine.throughput():.1f} tok/s")
    print(f"[serve-engine] KV pool: {engine.kv_pool_nbytes():,} bytes "
          f"(kv_bits={args.kv_bits or 'bf16'}, page_size={args.page_size}) "
          f"via QTensor.nbytes")


if __name__ == "__main__":
    main()
