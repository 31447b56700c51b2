"""Port parity — the serving engine at bf16 compute dtype.

The trace of ``test_torch_serve.py`` at bf16, weight_bits ∈ {0, 8, 4} ×
kv_bits ∈ {0, 8, 4}: the first generated token of every request is
identical, and under teacher forcing — both engines fed the reference's
tokens and starting each step from the reference's pages — the decode
logits agree within 3e-2 of their largest magnitude (XLA drops some bf16
roundings inside a fused layer that eager PyTorch keeps, so greedy chains
may part later; at 4 bits an ulp can flip a KV code, hence the page sync).
At bf16 a first token whose top-two logits lie within that noise is a coin
flip between the frameworks; the trace of seed 2 has no such near-tie (seed
0's has one, 5.510 against 5.505, at 8-bit weights).
"""
import numpy as np
import pytest

from torch_bridge import jax_decode_fn, jax_decode_logits, np32, pool_from_jax, serve_both

from repro.serve import Request as JRequest
from repro_torch.serve import Request as TRequest


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
@pytest.mark.parametrize("weight_bits", [0, 8, 4])
def test_bf16_first_token_and_teacher_forced_logits(weight_bits, kv_bits):
    jeng, teng, jres, tres = serve_both("bf16", weight_bits, kv_bits, seed=2)
    for rid, want in jres.items():
        got = tres[rid]
        assert got.tokens[got.prompt_len] == want.tokens[want.prompt_len], rid
        assert got.n_generated == want.n_generated
    teng.allocator.check_leaks(0)

    # teacher forcing over the first four requests, both engines drained
    rids = [0, 1, 2, 3]
    for rid in rids:
        full = jres[rid].tokens
        p = jres[rid].prompt_len
        jeng.submit(JRequest(rid=rid, prompt=full[:p], max_new_tokens=len(full)))
        teng.submit(TRequest(rid=rid, prompt=full[:p], max_new_tokens=len(full)))
    jeng._admit([])
    teng._admit([])
    np.testing.assert_array_equal(teng._bt, jeng._bt)
    fn = jax_decode_fn(jeng)
    bt = jeng._bt.copy()
    seqs = [jres[r].tokens for r in rids]
    plens = [jres[r].prompt_len for r in rids]
    v = jeng.cfg.vocab_size
    for j in range(max(len(s) - p for s, p in zip(seqs, plens)) - 1):
        pos = np.asarray([p + j for p in plens], np.int32)
        active = np.asarray([p + j + 1 < len(s) for s, p in zip(seqs, plens)])
        if not active.any():
            break
        tok = np.asarray([s[min(p + j, len(s) - 1)] for s, p in zip(seqs, plens)],
                         np.int32)
        pos = np.where(active, pos, 0)
        teng.pool = pool_from_jax(jeng.pool)
        want = np32(jax_decode_logits(jeng, fn, tok, pos, bt, active))[active, :v]
        got = np32(teng.decode_logits(tok, pos, bt, active))[active, :v]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=3e-2 * float(np.abs(want).max()))
