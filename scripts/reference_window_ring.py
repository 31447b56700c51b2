"""Where the sliding-window ring KV cache reads the window and where it
does not (ROADMAP C24), on the JAX reference and on the port, both on the
CPU, at the reduced mixtral-8x7b (window 32, query blocks of 16, f32,
random weights from ``PRNGKey(0)`` bridged into the port).

  PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_window_ring.py [--batch 2]

For each (prompt, ``pad_to``) case it decodes, teacher-forced, the tokens
after the prompt one step at a time from prefill(prompt, pad_to=) and
compares each step's logits with the last logits of a prefill of the whole
prefix (the windowed forward, which is right by construction): the gap is
the largest |difference| over the largest |logit|. Cases: 64/72 (prompt a
multiple of the window: the ring is the identity order), 40/48 (longer
than the window, not a multiple: the first step overwrites slot 40 % 32 =
8, which holds position 16, and position 8 stays), 32/48 (prompt = window:
the cache is padded to 48 rows and never cut back) and 20/44 (decoding
past position 32 on a padded cache). Tokens from ``default_rng(0)``.
Runs in ~1 min.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np

CASES = ((64, 72, 1), (40, 48, 1), (32, 48, 1), (20, 44, 20))   # prompt, pad_to, steps


def _gap(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
    import jax
    import jax.numpy as jnp
    import torch
    from torch_bridge import bridge

    from repro import configs as jconfigs
    from repro.models import transformer as JT
    from repro_torch import configs as tconfigs
    from repro_torch.models import transformer as TT

    jcfg = dataclasses.replace(jconfigs.get_reduced("mixtral-8x7b"), dtype=jnp.float32)
    tcfg = tconfigs.get_reduced("mixtral-8x7b", dtype=torch.float32)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge(jp)
    jstep = jax.jit(lambda p, s, t: JT.decode_step(p, s, t, jcfg))
    for plen, pad_to, steps in CASES:
        toks = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                                 (args.batch, plen + steps))
        sides = {
            "reference": (lambda t, n: JT.prefill(jp, jnp.asarray(t, jnp.int32), jcfg,
                                                  pad_to=n),
                          lambda s, t: jstep(jp, s, jnp.asarray(t, jnp.int32))),
            "port": (lambda t, n: TT.prefill_state(tp, torch.from_numpy(t), tcfg, pad_to=n),
                     lambda s, t: TT.decode_step(tp, s, torch.from_numpy(t), tcfg))}
        for name, (prefill, step) in sides.items():
            _, state = prefill(toks[:, :plen], pad_to)
            rows = state.layers.k.shape[2]
            gaps = []
            for i in range(steps):
                lg, state = step(state, toks[:, plen + i:plen + i + 1])
                want, _ = prefill(toks[:, :plen + i + 1], 0)
                gaps.append(_gap(lg[:, -1], want))
            where = ", ".join(f"pos {plen + i} {g:.2e}" for i, g in enumerate(gaps))
            print(f"prompt {plen}, pad_to {pad_to}, window {tcfg.window}, {rows} cache rows, "
                  f"{name}: gap {where}", flush=True)


if __name__ == "__main__":
    main()
