"""Step sizes for the full-width ``ds_mlp`` block of ``chip_smoke.py``'s
``[act-quant]`` phase, on the JAX reference (``repro.precision.act_quant``,
CPU).

  PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_ds_mlp_lr_sweep.py [--rows R] [lr ...]

gemma-2b's MLP at its published widths (d_model 2048, d_ff 16384, tanh
GELU), the three weights drawn as the reference's ``init_mlp`` draws them
(bf16). The input is gemma's layer-0 attention input on one 4 × 512 batch
of the training stream (``TokenStream``, seed 0, as ``chip_smoke.py`` reads
it): the RMS norm (gain 1 + 1) of the tokens' embedding rows, each distinct
token's row drawn as ``init_embedding`` draws a row. The stream's Zipf
tokens repeat (the commonest is ~18 % of the batch), so the rows are far
from independent, and that sets the step size. Target ``roll(x, 1,
axis=1)``, 8-bit double-sampled activations, 5 plain SGD steps
(``p − lr·∂p`` in bf16, a fresh ``fold_in`` key each step). ``--rows`` cuts
the batch to its first R rows (default all 2048). Prints each lr's 6
losses (before each step and after the last) and whether they fall at
every step.
"""
from __future__ import annotations

import argparse

import numpy as np
import jax
import jax.numpy as jnp

from repro.data.pipeline import TokenStream, TokenStreamConfig
from repro.models.layers import init_mlp, rmsnorm
from repro.precision.act_quant import ds_mlp

DEFAULT_LRS = (0.01, 0.03, 0.1, 0.3, 1.0, 3.0)
D_MODEL, D_FF, VOCAB, STEPS = 2048, 16384, 256000, 5


def main(rows: int, lrs):
    key = jax.random.PRNGKey(0)
    p0 = init_mlp(jax.random.fold_in(key, 1), D_MODEL, D_FF)
    stream = TokenStream(TokenStreamConfig(vocab_size=VOCAB, seq_len=512, global_batch=4))
    tokens = np.asarray(stream.next_batch()["tokens"]).reshape(-1)[:rows]
    uniq, inv = np.unique(tokens, return_inverse=True)
    table = (jax.random.normal(jax.random.fold_in(key, 2), (len(uniq), D_MODEL),
                               jnp.float32) * D_MODEL ** -0.5).astype(jnp.bfloat16)
    x = rmsnorm({"g": jnp.ones((D_MODEL,), jnp.bfloat16)}, table[jnp.asarray(inv)])
    target = jnp.roll(x, 1, axis=1)
    print(f"{rows} rows, {len(uniq)} distinct tokens, the commonest "
          f"{np.bincount(inv).max() / rows:.3f} of the rows", flush=True)

    def loss(p, k):
        y = ds_mlp(p, x, k, act="gelu", bits=8)
        return jnp.mean((y.astype(jnp.float32) - target.astype(jnp.float32)) ** 2)

    grad = jax.jit(jax.value_and_grad(loss))
    for lr in lrs:
        p, losses = p0, []
        for i in range(STEPS):
            value, g = grad(p, jax.random.fold_in(key, 100 + i))
            losses.append(float(value))
            p = jax.tree.map(lambda a, b: (a - lr * b).astype(a.dtype), p, g)
        losses.append(float(jax.jit(loss)(p, jax.random.fold_in(key, 100 + STEPS))))
        falls = all(b < a for a, b in zip(losses, losses[1:]))
        print(f"lr {lr}: losses {[round(v, 6) for v in losses]} falls at every step "
              f"{falls}", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("lrs", type=float, nargs="*")
    args = ap.parse_args()
    main(args.rows, args.lrs or DEFAULT_LRS)
