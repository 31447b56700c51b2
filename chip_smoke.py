"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

  python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit) and builds every
   hand-written CUDA kernel from ``src/repro_torch/kernels/csrc``;
2. holds each kernel against its plain PyTorch version on the card at the
   shapes of the gemma-2b serving path, and times the kernel, the plain
   version and a PyTorch library yardstick beside the card's bound;
3. serves full-width gemma-2b (18 layers, d_model 2048, vocab 256000, random
   weights from seed 0) through ``repro_torch.launch.serve.serve_engine`` at
   weight/KV bits 8/8 and 4/4 — 8 requests each — with every kernel's launch
   counter set to 0 just before and read just after each run;
4. checks the served output: every request finished with in-vocab tokens,
   and the reduced model on the card agrees with the same engine's plain
   path on the CPU;
5. prints a ``{"kernels": [...]}`` line and, last, the result line
   ``{"ok": true, "device": {...}}``.

Any failure raises (exit code ≠ 0) and prints no result line; so does a
machine without a card, or a directory without the repository's sources.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA data sheet
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core peak
QMM_SHAPES = [(4, 2048, 2048), (4, 2048, 256), (4, 2048, 16384),
              (4, 16384, 2048), (128, 2048, 16384)]
QMM_TOL = 1e-5                # rel to max|plain|: f32 dequant, f32 accumulation order
ATTN_TOL = 1e-4               # abs: both f32 online softmax, summation order only
ATTN_LENS = [160, 97, 33, 1]


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


def _bound(nbytes: int, ops: int):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_qmm(dev, flush):
    import torch
    from repro_torch.kernels import qmm as Q
    from repro_torch.quant import QScheme, encode

    rows = []
    gen = torch.Generator(device=dev).manual_seed(1)
    for bits in (8, 4):
        packed = bits == 4
        for m, k, n in QMM_SHAPES:
            w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
            qt = encode(w, QScheme.int_symmetric(bits, scaling="channel",
                                                 rounding="nearest", packed=packed))
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            got = Q.qmm(x, qt.codes, qt.scale, packed=packed)
            want = Q.qmm_plain(x, qt.codes, qt.scale, packed=packed)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ref_max = float(want.abs().max())
            if not err <= QMM_TOL * ref_max:
                raise AssertionError(f"qmm int{bits} {m}x{k}x{n}: max err {err} "
                                     f"> {QMM_TOL} x {ref_max}")
            w_bf16 = qt.decode().to(torch.bfloat16)
            ms = _timed(lambda: Q.qmm(x, qt.codes, qt.scale, packed=packed), flush)
            plain_ms = _timed(lambda: Q.qmm_plain(x, qt.codes, qt.scale, packed=packed), flush)
            lib_ms = _timed(lambda: torch.matmul(x, w_bf16), flush)
            nbytes = x.numel() * 2 + qt.codes.numel() + n * 4 + m * n * 4
            bound_ms, bound_by = _bound(nbytes, 2 * m * k * n)
            rows.append({"name": f"qmm int{bits} M{m} K{k} N{n}", "key": (packed, m, k, n),
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by})
            print(f"[kernel] qmm int{bits} (M,K,N)=({m},{k},{n}): max_err={err:.3e} "
                  f"(tol {QMM_TOL:g} x {ref_max:.3g}) kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by})", flush=True)
    return rows


def check_paged_attn(dev, flush):
    import torch
    from repro_torch.kernels import paged_attn as PA
    from repro_torch.serve import pages as pg

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
        args = (q, kp, vp, ksc, vsc, bt, lens)
        kw = dict(softmax_scale=d ** -0.5, kv_bits=bits)
        got = PA.paged_decode_attn(*args, **kw)
        want = PA.paged_decode_attn_plain(*args, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= ATTN_TOL:
            raise AssertionError(f"paged_decode_attn kv{bits}: max err {err} > {ATTN_TOL}")
        # library yardstick: SDPA over the gathered, dequantized rows
        from repro_torch.kernels.ref import dequant_pages_ref, gather_pages_ref
        kk = dequant_pages_ref(gather_pages_ref(kp, bt), gather_pages_ref(ksc, bt) if bits else None)
        vv = dequant_pages_ref(gather_pages_ref(vp, bt), gather_pages_ref(vsc, bt) if bits else None)
        kk = kk.to(torch.bfloat16).permute(0, 2, 1, 3).expand(b, h, -1, d).contiguous()
        vv = vv.to(torch.bfloat16).permute(0, 2, 1, 3).expand(b, h, -1, d).contiguous()
        mask = (torch.arange(kk.shape[2], device=dev)[None, :] < lens[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        ms = _timed(lambda: PA.paged_decode_attn(*args, **kw), flush)
        plain_ms = _timed(lambda: PA.paged_decode_attn_plain(*args, **kw), flush)
        lib_ms = _timed(lambda: sdpa(q4, kk, vv, attn_mask=mask), flush)
        rows_kv = int(lens.sum())
        row_bytes = {0: d * 2, 8: d + 4, 4: d // 2 + 4}[bits]
        nbytes = q.numel() * 2 + 2 * rows_kv * hkv * row_bytes + bt.numel() * 4 + b * 4 \
            + b * h * d * 4
        bound_ms, bound_by = _bound(nbytes, 4 * rows_kv * h * d)
        name = {0: "bf16", 8: "int8", 4: "int4"}[bits]
        rows.append({"name": f"paged_decode_attn {name} B{b} H{h} Hkv{hkv} D{d} page{page}",
                     "kv_bits": bits, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"[kernel] paged_decode_attn {name} B={b} H={h} Hkv={hkv} D={d} page={page} "
              f"lens={ATTN_LENS}: max_err={err:.3e} (tol {ATTN_TOL:g}) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} "
              f"({bound_by})", flush=True)
    return rows


def serve(bits: int, dev):
    """Drive the main path once; returns (launch counts, qmm shape counts,
    summary)."""
    import torch
    from repro_torch.kernels import paged_attn as PA
    from repro_torch.kernels import qmm as Q
    from repro_torch.launch.serve import serve_engine

    Q.launches = 0
    Q.shape_launches.clear()
    PA.launches = 0
    t0 = time.perf_counter()
    engine, results = serve_engine(
        "gemma-2b", reduced=False, weight_bits=bits, kv_bits=bits, n_requests=8,
        max_slots=4, page_size=16, max_prompt=128, max_new=32, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"qmm": Q.launches, "paged_decode_attn": PA.launches}
    shapes = dict(Q.shape_launches)
    cfg, st = engine.cfg, engine.stats
    if cfg.n_layers != 18 or cfg.d_model != 2048 or cfg.vocab_size != 256000:
        raise AssertionError(f"not full-width gemma-2b: {cfg}")
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
    per_step_qmm = 7 * cfg.n_layers
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
               "launches": launches,
               "launches_per_decode_step": {"qmm": per_step_qmm,
                                            "paged_decode_attn": cfg.n_layers}}
    print(f"[serve] gemma-2b full width, weight/kv bits {bits}/{bits}: "
          f"{len(results)} requests finished, {n_gen} tokens generated in "
          f"{st['decode_steps']} decode steps (+{st['prefill_tokens']} prefill tokens); "
          f"steady-state decode {summary['decode_tokens_per_s']:.1f} tok/s "
          f"({summary['mean_decode_step_ms']:.2f} ms/step); KV pool "
          f"{summary['kv_pool_bytes']:,} bytes; weights {summary['weight_bytes']:,} bytes; "
          f"launches qmm={launches['qmm']} paged_decode_attn={launches['paged_decode_attn']}",
          flush=True)
    summary["profile"] = profile_decode(engine)
    del engine
    torch.cuda.empty_cache()
    return launches, shapes, summary


def profile_decode(engine, steps: int = 5):
    """Where a decode step's time goes: ``torch.profiler`` over ``steps``
    steady decode steps of 4 live requests — device time by kernel, and the
    device's idle share of the window's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import make_trace

    for r in make_trace(4, engine.cfg.vocab_size, max_new=steps + 4,
                        min_prompt=64, max_prompt=64, seed=7):
        engine.submit(r)
    engine.step()                                  # admit all four + one decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel, n_kernels = {}, 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:      # device-side events only
            continue
        n_kernels += ev.count
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us:
            by_kernel[ev.key] = dev_us / 1e3
    while engine.busy:
        engine.step()
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_events_per_step": n_kernels / steps,
           "device_ms_per_step": device_ms / steps if device_ms else None,
           "device_idle_share": 1 - device_ms / wall_ms if device_ms else None,
           "top_kernels_ms_per_step": {k[:60]: v / steps for k, v in top}}
    if device_ms:
        print(f"[profile] {steps} decode steps x 4 live slots: wall {out['wall_ms_per_step']:.2f} "
              f"ms/step, {out['device_events_per_step']:.0f} device events/step, device busy "
              f"{out['device_ms_per_step']:.2f} ms/step, idle share "
              f"{out['device_idle_share']:.3f}; top: " + "; ".join(
                  f"{k[:40]} {v:.3f}" for k, v in out["top_kernels_ms_per_step"].items()),
              flush=True)
    else:
        print("[profile] torch.profiler recorded no device time: not measured", flush=True)
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

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {sorted(_build.sources())} built in {build_s:.1f} s "
          f"into {_build.build_dir()}", flush=True)
    for name, info in sorted(_build.BUILD_LOG.items()):
        for line in info["ptxas"].splitlines():
            if "Used" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    qmm_rows = check_qmm(dev, flush)
    attn_rows = check_paged_attn(dev, flush)
    del flush
    torch.cuda.empty_cache()

    runs = {bits: serve(bits, dev) for bits in (8, 4)}
    small = agree_small(dev)

    kernels = []
    for r in qmm_rows:
        packed, m, k, n = r.pop("key")
        shapes = runs[4 if packed else 8][1]
        decode = m <= 8
        r["launches"] = sum(c for (p, mm, kk, nn), c in shapes.items()
                            if p == packed and kk == k and nn == n and (mm <= 8) == decode)
        kernels.append({"name": r.pop("name"), "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/qmm.cu",
                        "replaces": "src/repro/kernels/qmm.py:158", **r})
    for r in attn_rows:
        bits = r.pop("kv_bits")
        r["launches"] = runs[bits][0]["paged_decode_attn"] if bits in runs else 0
        kernels.append({"name": r.pop("name"), "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
                        "replaces": "src/repro/kernels/paged_attn.py:195", **r})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: r[k] for k in keys} for r in kernels]

    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    report = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_seconds": build_s, "kernels": kernels,
              "serve": [runs[b][2] for b in (8, 4)], "small_agreement": small}
    (out_dir / "chip_smoke_report.json").write_text(json.dumps(report, indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
