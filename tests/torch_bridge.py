"""Helpers shared by the ``test_torch_*`` parity tests: carry JAX values
across as numpy, and the reference engine's paged decode step returning
logits (the engine itself only returns tokens) for teacher forcing."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.quant import QTensor as JQTensor
from repro_torch.interop import key_from_numpy, params_from_numpy


def jax_to_numpy(tree):
    """A JAX param tree as nested dicts of numpy arrays, QTensors in the
    ``{"codes", "scale", "scheme"[, "levels"]}`` form ``interop`` reads."""
    if isinstance(tree, JQTensor):
        out = {"codes": np.asarray(tree.codes), "scale": np.asarray(tree.scale),
               "scheme": dataclasses.asdict(tree.scheme)}
        if tree.levels is not None:
            out["levels"] = np.asarray(tree.levels)
        return out
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def bridge(tree, device="cpu"):
    """JAX params → the port's params."""
    return params_from_numpy(jax_to_numpy(tree), device)


def train_state_to_numpy(state):
    """A reference ``TrainState`` in the numpy form
    ``interop.train_state_from_numpy`` reads."""
    return {"params": jax_to_numpy(state.params),
            "opt": {"step": int(state.opt.step), "m": jax_to_numpy(state.opt.m),
                    "v": jax_to_numpy(state.opt.v),
                    "master": jax_to_numpy(state.opt.master)},
            "channels": jax_to_numpy(state.channels), "step": int(state.step),
            "rng": np.asarray(state.rng), "epoch": int(state.epoch)}


def key(jkey):
    """A JAX PRNG key → the port's key (the same threefry words)."""
    return key_from_numpy(np.asarray(jkey))


def pool_from_jax(pool, device="cpu"):
    """A reference ``PagedKVPool`` as the port's (a copy of every plane)."""
    from repro_torch.interop import tensor_from_numpy
    from repro_torch.serve.pages import PagedKVPool

    return PagedKVPool(*[None if a is None else tensor_from_numpy(np.asarray(a), device)
                         for a in pool])


def np32(t):
    """A torch or JAX array as f32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).cpu().numpy()
    return np.array(jnp.asarray(t, jnp.float32), copy=True)


def jax_decode_fn(eng):
    """The decode step of a reference ``ServeEngine`` with logits instead of
    tokens: the engine's own jitted body (``lax.scan`` over layers, the
    ``ref`` backend), ``fn(params, pool, tokens, positions, block_table,
    active) -> (logits (B, V), new_pool)``."""
    from repro.kernels import registry
    from repro.models import attention as attn
    from repro.models import transformer as T
    from repro.models.layers import dense, embed
    from repro.serve import pages as pg

    cfg, spec, page = eng.cfg, eng.cfg.attn_spec, eng.page_size
    kb = registry.get("ref")

    def fn(params, pool, tokens, positions, block_table, active):
        b = tokens.shape[0]
        pos = positions.astype(jnp.int32)
        x = embed(params["embed"], tokens[:, None]).astype(cfg.dtype)
        page_ids = jnp.take_along_axis(block_table, (pos // page)[:, None],
                                       axis=1)[:, 0]
        page_ids = jnp.where(active, page_ids, 0)
        offs = pos % page
        new_lens = pos + active.astype(jnp.int32)

        def body(h, inp):
            layer, kp, vp, ks, vs = inp
            box = {}

            def attend(z):
                q, k, v = attn.decode_qkv(layer["attn"], z, spec, pos[:, None])
                box["planes"] = pg.append_rows(kp, vp, ks, vs, k[:, 0], v[:, 0],
                                               page_ids, offs)
                out = kb.paged_attention(q[:, 0], *box["planes"], block_table,
                                         new_lens, softmax_scale=spec.scale)
                return dense(layer["attn"]["o"],
                             out.reshape(b, 1, spec.n_heads * spec.head_dim))

            h = T.decode_layer_block(cfg, layer, h, attend)
            return h, box["planes"]

        xs = (params["layers"], pool.k_pages, pool.v_pages, pool.k_scale,
              pool.v_scale)
        x, planes = jax.lax.scan(body, x, xs)
        return T.final_logits(params, cfg, x)[:, 0], pg.PagedKVPool(*planes)

    return jax.jit(fn)


def jax_decode_logits(eng, fn, tokens, positions, block_table, active):
    """Run ``fn`` (from :func:`jax_decode_fn`) on the engine's params and
    pool at host-given arrays; updates ``eng.pool`` and returns logits."""
    logits, eng.pool = fn(eng.params, eng.pool, jnp.asarray(tokens, jnp.int32),
                          jnp.asarray(positions, jnp.int32),
                          jnp.asarray(block_table, jnp.int32),
                          jnp.asarray(active))
    return logits


def with_biases(params, seed: int, scale: float = 0.5):
    """A JAX param tree whose every bias leaf ``b`` (zeros at init) is
    replaced by N(0, scale²) draws from ``default_rng(seed)`` in the leaf's
    dtype, in sorted-key order — so a test fails if a bias is never added."""
    rng = np.random.default_rng(seed)

    def go(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k in sorted(node):
            v = node[k]
            if k == "b" and not isinstance(v, dict):
                draw = rng.normal(0.0, scale, v.shape).astype(np.float32)
                out[k] = jnp.asarray(draw, v.dtype)
            else:
                out[k] = go(v)
        return out

    return go(params)


def serve_both(dtype: str, weight_bits: int, kv_bits: int, *, n_requests=8,
               max_new=8, max_prompt=16, page_size=8, seed=0,
               include_embedding=False, arch="gemma-2b", bias_seed=None):
    """Serve the same ``make_trace`` through the reference engine (``ref``
    backend) and the port's engine on the CPU, with the reference's params
    of the reduced ``arch`` bridged across (``include_embedding`` quantizes
    the embedding table too; ``bias_seed`` draws nonzero q/k/v biases into
    both trees, :func:`with_biases`). Returns (ref_engine, port_engine,
    ref_results, port_results)."""
    from repro import configs as jconfigs
    from repro.launch.serve import make_trace as jtrace
    from repro.models import transformer as JT
    from repro.precision.qat import quantize_param_tree
    from repro.quant import PrecisionPlan as JPlan
    from repro.serve import ServeEngine as JEngine
    from repro_torch import configs as tconfigs
    from repro_torch.launch.serve import make_trace as ttrace
    from repro_torch.quant import PrecisionPlan as TPlan
    from repro_torch.serve import ServeEngine as TEngine

    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else \
        (jnp.bfloat16, torch.bfloat16)
    kw = dict(kv_bits=kv_bits, model_bits=weight_bits,
              model_storage="int" if weight_bits else "fake")
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), dtype=jd)
    tcfg = tconfigs.get_reduced(arch, dtype=td)
    params = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    if bias_seed is not None:
        params = with_biases(params, bias_seed)
    if weight_bits:
        params = quantize_param_tree(params, bits=weight_bits,
                                     include_embedding=include_embedding)
    ekw = dict(max_slots=4, page_size=page_size,
               max_seq_len=max_prompt + max_new + page_size)
    jeng = JEngine(params, jcfg, plan=JPlan(**kw), backend="ref", **ekw)
    teng = TEngine(bridge(params), tcfg, plan=TPlan(**kw), device="cpu", **ekw)
    tkw = dict(max_new=max_new, max_prompt=max_prompt, seed=seed)
    jres = jeng.run(jtrace(n_requests, jcfg.vocab_size, **tkw))
    tres = teng.run(ttrace(n_requests, tcfg.vocab_size, **tkw))
    return jeng, teng, jres, tres


_REF_JITS: dict = {}


def ref_engine(params, cfg, **kw):
    """A reference ``ServeEngine`` that reuses the jitted programs of an
    earlier engine built here with the same configuration: the reference
    makes its jitted closures per instance, over constants of the
    configuration alone (cfg, plan, page size, slots, context, chunk width,
    speculation, backend), so an engine of the same configuration runs the
    same programs — only their compile is saved."""
    from repro.serve import ServeEngine as JEngine

    eng = JEngine(params, cfg, **kw)
    key = (repr(eng.cfg), eng.page_size, eng.max_slots, eng.max_seq_len,
           eng.chunk_pages, eng.spec_decode, eng.draft_bits, eng.backend)
    prev = _REF_JITS.get(key)
    if prev is None:
        _REF_JITS[key] = prev = eng
        if eng.chunk_pages is not None:
            eng._chunk_jit()
        if eng.spec_decode:
            eng._draft_jit()
    eng._decode_jits = prev._decode_jits
    eng._prefill_jits = prev._prefill_jits
    eng._verify_jits = prev._verify_jits
    eng._chunk_jit_fn = prev._chunk_jit_fn
    eng._draft_jit_fn = prev._draft_jit_fn
    eng._sample1 = prev._sample1
    return eng
