"""Where the hybrid's shared-block KV rows start to part from the
reference's (ROADMAP C22): the reduced zamba2-2.7b at f32 on the CPU, the
reference's random weights (``PRNGKey(0)``) bridged into the port, the
prompts of ``tests/test_torch_hybrid.py``'s prefill test (2 × 20 tokens
from ``default_rng(2)``).

  PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/hybrid_kv_divergence.py [--shape reduced|hd80] [--prompt 20]

For each application g of the shared block (after every
``shared_attn_every`` Mamba2 layers) it prints, as max |difference| over
the reference's largest magnitude:

* ``chained``: the shared block's input, each package running its own
  chain from the embedding — how far the two streams have parted there;
* ``segment alone``: the port's Mamba2 layers of segment g fed the
  reference's own input to that segment, against the reference's output;
* ``block alone``: the port's shared block (its K and V before they are
  quantized, and its output) fed the reference's own input to the block;
* the K/V rows of the chained runs before quantization, and how many int8
  and int4 codes (``pages.quant_rows``, the ring cache's) round apart, in
  the chained runs and with the block alone.

The reference runs jitted, one segment and one block at a time, as its
``prefill`` does inside its scan; the port runs eagerly.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

from torch_bridge import bridge, np32  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.layers import embed as jembed  # noqa: E402
from repro.models.layers import mlp as jmlp  # noqa: E402
from repro.models.layers import rmsnorm as jrmsnorm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.layers import embed as tembed  # noqa: E402
from repro_torch.models.layers import layer_view, rmsnorm  # noqa: E402
from repro_torch.serve.pages import quant_rows  # noqa: E402

ARCH = "zamba2-2.7b"
SHAPES = {"reduced": {}, "hd80": dict(head_dim=80, n_heads=2, n_kv_heads=2)}


def _rel(got, want) -> float:
    want = np32(want)
    return float(np.abs(np32(got) - want).max() / np.abs(want).max())


def _flips(kt, kj, bits) -> tuple[int, int]:
    """(codes that differ, codes) of the two packages' rows quantized as
    the ring cache quantizes them."""
    from repro_torch.quant.qtensor import unpack_int4

    a, _ = quant_rows(torch.from_numpy(np32(kt)), bits)
    b, _ = quant_rows(torch.from_numpy(np32(kj)), bits)
    if bits == 4:
        a, b = unpack_int4(a), unpack_int4(b)
    return int((a != b).sum()), a.numel()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="reduced", choices=sorted(SHAPES))
    ap.add_argument("--prompt", type=int, default=20)
    args = ap.parse_args()
    over = SHAPES[args.shape]
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype=jnp.float32, **over)
    tcfg = tconfigs.get_reduced(ARCH, dtype=torch.float32, **over)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge(jp)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, args.prompt))
    k = jcfg.shared_attn_every
    n_seg = jcfg.n_layers // k

    def jbody(h, layer):
        out, _ = jssm.mamba2_forward(layer["mamba"], jrmsnorm(layer["norm"], h),
                                     jcfg.ssm_spec, return_state=True)
        return h + out, None

    @jax.jit
    def jseg(seg, h):
        return jax.lax.scan(jbody, h, seg)[0]

    @jax.jit
    def jblock(blk, h):
        a_out, (kk, vv) = jattn.attention_block(blk["attn"], jrmsnorm(blk["ln1"], h),
                                                jcfg.attn_spec, return_kv=True)
        h = h + a_out
        return h + jmlp(blk["mlp"], jrmsnorm(blk["ln2"], h), jcfg.mlp_act), kk, vv

    def tseg(g, h):
        for i in range(g * k, (g + 1) * k):
            layer = layer_view(tp["layers"], i)
            out, _ = tssm.mamba2_forward(layer["mamba"], rmsnorm(layer["norm"], h),
                                         tcfg.ssm_spec, return_state=True)
            h = h + out
        return h

    seg_params = jax.tree.map(lambda a: a.reshape(n_seg, k, *a.shape[1:]), jp["layers"])
    hj = jembed(jp["embed"], jnp.asarray(toks, jnp.int32)).astype(jnp.float32)
    with torch.no_grad():
        ht = tembed(tp["embed"], torch.from_numpy(toks), torch.float32).to(torch.float32)
        print(f"reduced zamba2-2.7b ({args.shape}) f32, prompts 2 x {args.prompt}, "
              f"{n_seg} applications of the shared block after every {k} layers; "
              "max |diff| / max |reference|:")
        print(f"  embedding: {_rel(ht, hj):.3e}")
        for g in range(n_seg):
            seg = jax.tree.map(lambda a: a[g], seg_params)
            hj_in = hj
            hj = jseg(seg, hj)
            alone = tseg(g, torch.from_numpy(np32(hj_in)))
            ht = tseg(g, ht)
            print(f"  segment {g} (layers {g * k}..{(g + 1) * k - 1}) out: chained "
                  f"{_rel(ht, hj):.3e}, segment alone {_rel(alone, hj):.3e}")
            hj_blk, kj, vj = jblock(jp["shared_attn"], hj)
            blk_in = torch.from_numpy(np32(hj))
            hb, kb, vb = TT._attn_block_kv(tcfg, tp["shared_attn"], blk_in)
            ht, kt, vt = TT._attn_block_kv(tcfg, tp["shared_attn"], ht)
            fl = {b: [sum(x) for x in zip(_flips(kt, kj, b), _flips(vt, vj, b))]
                  for b in (8, 4)}
            fa = {b: _flips(kb, kj, b)[0] + _flips(vb, vj, b)[0] for b in (8, 4)}
            print(f"  shared block {g}: block alone K {_rel(kb, kj):.3e} V {_rel(vb, vj):.3e} "
                  f"out {_rel(hb, hj_blk):.3e}; chained K {_rel(kt, kj):.3e} "
                  f"V {_rel(vt, vj):.3e} out {_rel(ht, hj_blk):.3e}; codes apart: "
                  f"int8 {fl[8][0]}/{fl[8][1]}, int4 {fl[4][0]}/{fl[4][1]} (block alone: int8 "
                  f"{fa[8]}, int4 {fa[4]})", flush=True)
            hj = hj_blk


if __name__ == "__main__":
    main()
