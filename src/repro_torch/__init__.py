"""repro_torch — the PyTorch/CUDA port of :mod:`repro`, slice by slice.

The JAX/Pallas package ``repro`` is the reference; this package re-implements
it in PyTorch for one NVIDIA H100, with every TPU kernel on a ported path
rewritten as a hand-written Hopper kernel (``kernels/csrc``). It never
imports JAX or ``repro``; only the parity tests load both.

Seven slices are ported: serving (``launch/serve.serve_engine``: int
weights at rest — or variance-optimal level tables, ``optimal_levels`` —
a paged quantized KV pool, greedy decode; kernels ``qmm`` and
``paged_attn``), the paper's linear-model SGD (``core/linear``: linear
regression and LS-SVM, kernels ``ds_quant`` and ``qmv``; the §4 Chebyshev
logistic regression and SVM with ℓ1 refetching and the §3 optimal sample
levels of ``core/chebyshev`` and ``core/optimal``), the row-scaled
quantizer entry points (``kernels/ops.quantize_rows``, ``ds_quantize``;
kernels ``row_absmax`` and ``stoch_quant``), LM training (``launch/train`` →
``train.Trainer``: ship-quantized int8 weights, int8 gradients with error
feedback, int8 AdamW moments; kernels ``qmm``, ``qmm_t`` and
``quant_adamw``) and any-precision serving (``serve_engine(weight_layout=
'bitplane')``: bitplane weights, the ``weights-bitplane-v1`` artifact of
``ckpt``, ``set_weight_bits``, self-speculative decoding, the precision
autoscaler; kernel ``qmm_bitplane``), the §3.4 activation channel and
quantized embedding tables (``precision/act_quant``; kernel ``qmm_qout``)
and mamba2-780m served through the legacy loop (``launch/serve.serve``:
SSD prefill, O(1) recurrent decode; kernel ``ssd_chunk_scan``). Parts of
``repro`` outside the slices raise
``NotImplementedError`` naming the ROADMAP item that ports them.

Devices: every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; asking for ``cuda`` without a card raises.
"""
import torch


def resolve_device(device) -> torch.device:
    """The one device rule: ``None`` means ``cuda``; a ``cuda`` device on a
    machine without a card raises instead of silently running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


__all__ = ["resolve_device"]
