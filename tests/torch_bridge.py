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
    ``{"codes", "scale", "scheme"}`` form ``interop`` reads."""
    if isinstance(tree, JQTensor):
        return {"codes": np.asarray(tree.codes), "scale": np.asarray(tree.scale),
                "scheme": dataclasses.asdict(tree.scheme)}
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def bridge(tree, device="cpu"):
    """JAX params → the port's params."""
    return params_from_numpy(jax_to_numpy(tree), device)


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


def serve_both(dtype: str, weight_bits: int, kv_bits: int, *, n_requests=8,
               max_new=8, max_prompt=16, page_size=8, seed=0):
    """Serve the same ``make_trace`` through the reference engine (``ref``
    backend) and the port's engine on the CPU, with the reference's params
    bridged across. Returns (ref_engine, port_engine, ref_results,
    port_results)."""
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
    jcfg = dataclasses.replace(jconfigs.get_reduced("gemma-2b"), dtype=jd)
    tcfg = tconfigs.get_reduced("gemma-2b", dtype=td)
    params = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    if weight_bits:
        params = quantize_param_tree(params, bits=weight_bits)
    ekw = dict(max_slots=4, page_size=page_size,
               max_seq_len=max_prompt + max_new + page_size)
    jeng = JEngine(params, jcfg, plan=JPlan(**kw), backend="ref", **ekw)
    teng = TEngine(bridge(params), tcfg, plan=TPlan(**kw), device="cpu", **ekw)
    tkw = dict(max_new=max_new, max_prompt=max_prompt, seed=seed)
    jres = jeng.run(jtrace(n_requests, jcfg.vocab_size, **tkw))
    tres = teng.run(ttrace(n_requests, tcfg.vocab_size, **tkw))
    return jeng, teng, jres, tres
