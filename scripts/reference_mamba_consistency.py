"""How far apart prefill(prompt[:, :-1]) + one decode step and
prefill(prompt) land on the last logits of a deep mamba2 stack, or of the
hybrid zamba2 stack, on the JAX reference and on the port (both on the
CPU), at f32 and at bf16.

  PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_mamba_consistency.py [--layers 48] [--d-model 64] [--prompt 256]
  PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_mamba_consistency.py --full [--layers 48] [--batch 2] [--prompt 1024]
  PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_mamba_consistency.py --arch zamba2-2.7b [--full] [--batch 1] [--prompt 1024]

``--arch`` (mamba2-780m, or zamba2-2.7b: 54 Mamba2 layers with the shared
attention block after every 9). The reduced config with its depth set to
``--layers`` (default the full model's: 48, or 54) and ``--d-model`` (64),
state 32, head_dim 16, vocab 512 (zamba2: its reduced attention block, 4
heads of 16, d_ff 128, applied after every 9 layers as the full model's);
or, with ``--full``, the full model's config at depth ``--layers``: mamba2
(d_model 1536, 48 heads x 64, state 128, vocab 50280) takes several GB of
host memory and ~2.5 minutes a dtype on 8 cores at batch 4; zamba2
(d_model 2560, 80 heads x 64, state 64, vocab 32000; 2.34 B parameters)
two copies of ~9.4 GB at f32 while the weights are bridged. Random weights
from ``PRNGKey(0)``, bridged into the port; ``--batch`` prompts of
``--prompt`` random tokens. The prefill runs the chunked SSD form, the
decode step the recurrence, and the prefill's causal conv sums in the
activation dtype where the decode's sums in f32, so the two paths round
differently at every layer. zamba2's prefills reserve ``--prompt`` rows in
its shared KV caches (``pad_to``), so the decode step appends the last
token's row after the 1023 of prompt[:, :-1] instead of overwriting the
last one. Prints, per dtype and package, the largest |logit| over the real
vocab, the largest |difference| and how many argmaxes agree; then how far
the port's prefill logits are from the reference's.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import sys
import time
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

from torch_bridge import bridge, np32  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch.steps import make_serve_step  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402


def _report(name, full, last, vocab):
    f, la = np32(full)[:, :vocab], np32(last)[:, :vocab]
    print(f"{name}: largest |logit| {np.abs(f).max():.6g}, max |difference| "
          f"{np.abs(f - la).max():.6g}, argmax equal {(f.argmax(-1) == la.argmax(-1)).sum()}"
          f"/{f.shape[0]}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m", choices=("mamba2-780m", "zamba2-2.7b"))
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default the full model's: 48 or 54)")
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--dtypes", default="f32,bf16")
    args = ap.parse_args()
    layers = args.layers or jconfigs.get_config(args.arch).n_layers
    if args.full:
        jbase, tbase = jconfigs.get_config(args.arch), tconfigs.get_config(args.arch)
        shape = dict(n_layers=layers)
    else:
        jbase, tbase = jconfigs.get_reduced(args.arch), tconfigs.get_reduced(args.arch)
        shape = dict(n_layers=layers, d_model=args.d_model, ssm_state=32,
                     ssm_head_dim=16, vocab_size=512)
        if jbase.family == "hybrid":
            shape["shared_attn_every"] = jconfigs.get_config(args.arch).shared_attn_every
    # the hybrid's shared caches get a row for the decoded token
    pad = args.prompt if jbase.family == "hybrid" else 0
    vocab = shape.get("vocab_size", jbase.vocab_size)
    toks = np.random.default_rng(0).integers(0, vocab, (args.batch, args.prompt)).astype(np.int32)
    dtypes = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
    for name in args.dtypes.split(","):
        jd, td = dtypes[name]
        t0 = time.perf_counter()
        jcfg = dataclasses.replace(jbase, dtype=jd, **shape)
        tcfg = dataclasses.replace(tbase, dtype=td, **shape)
        print(f"{name}: {args.arch} layers {jcfg.n_layers}, d_model {jcfg.d_model}, state "
              f"{jcfg.ssm_state}, head_dim {jcfg.ssm_head_dim}, vocab {jcfg.vocab_size}, "
              f"{args.batch} prompts of {args.prompt}", flush=True)
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        prefill = jax.jit(lambda p, t, c=jcfg: JT.prefill(p, t, c, pad_to=pad))
        jfull, _ = prefill(jp, jnp.asarray(toks))
        _, js = prefill(jp, jnp.asarray(toks[:, :-1]))
        jlast, _ = jax.jit(lambda p, s, t, c=jcfg: JT.decode_step(p, s, t, c))(
            jp, js, jnp.asarray(toks[:, -1:]))
        _report(f"{name} reference", jfull, jlast[:, -1], jcfg.vocab_size)
        tp = bridge(jp)
        jfull = np32(jfull)[:, :jcfg.vocab_size]
        del jp, js, jlast
        gc.collect()
        with torch.no_grad():
            tfull, _ = TT.prefill_state(tp, torch.from_numpy(toks), tcfg, pad_to=pad)
            _, ts = TT.prefill_state(tp, torch.from_numpy(toks[:, :-1]), tcfg, pad_to=pad)
            tlast, _, _ = make_serve_step(tcfg)(tp, ts, torch.from_numpy(toks[:, -1:]))
        _report(f"{name} port     ", tfull, tlast[:, -1], tcfg.vocab_size)
        tf = np32(tfull)[:, :tcfg.vocab_size]
        print(f"{name} port vs reference, prefill(p) logits: max |difference| "
              f"{np.abs(tf - jfull).max():.6g}, argmax equal "
              f"{(tf.argmax(-1) == jfull.argmax(-1)).sum()}/{tf.shape[0]} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
        del tp, ts, tfull, tlast
        gc.collect()


if __name__ == "__main__":
    main()
