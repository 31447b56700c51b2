"""PrecisionPlan — one four-channel precision config (port of
``repro.quant.plan``).

ZipML applies the same unbiased quantizer Q(v, s) to **samples**, the
**model**, **gradients** and **activations**, plus the serving KV cache.
Fields (bits per channel; 0 = full precision): ``sample_bits``,
``model_bits`` (``model_storage`` 'fake' | 'int' | 'ship'), ``grad_bits``,
``act_bits``, ``kv_bits``; ``mode`` picks the linear-suite estimator and
``optimal_levels`` the variance-optimal grid. Legacy keyword spellings
still work and warn, exactly as in the reference.
"""
from __future__ import annotations

import dataclasses
import warnings

_LEGACY_KWARGS = {
    "bits_sample": "sample_bits",
    "bits_model": "model_bits",
    "bits_grad": "grad_bits",
    "weight_bits": "model_bits",
    "act_ds_bits": "act_bits",
    "use_optimal_levels": "optimal_levels",
    "weight_storage": "model_storage",
}


def _warn_legacy(old: str, new: str):
    warnings.warn(
        f"PrecisionPlan.{old} is deprecated; use PrecisionPlan.{new} "
        f"(see the README deprecation table)",
        DeprecationWarning, stacklevel=3)


@dataclasses.dataclass(frozen=True, init=False)
class PrecisionPlan:
    mode: str = "full"
    sample_bits: int = 5
    model_bits: int = 0
    grad_bits: int = 0
    act_bits: int = 0
    kv_bits: int = 0
    model_storage: str = "fake"     # 'fake' | 'int' | 'ship'
    optimal_levels: bool = False
    optimal_method: str = "discretized"
    backend: str | None = None      # kernel backend; None = registry default

    def __init__(self, mode: str = "full", **kw):
        legacy = [k for k in kw if k in _LEGACY_KWARGS]
        for k in legacy:
            if _LEGACY_KWARGS[k] in kw:
                raise TypeError(
                    f"PrecisionPlan got both {k!r} (deprecated) and its "
                    f"canonical spelling {_LEGACY_KWARGS[k]!r}")
            _warn_legacy(k, _LEGACY_KWARGS[k])
            kw[_LEGACY_KWARGS[k]] = kw.pop(k)
        fields = {f.name: f.default for f in dataclasses.fields(self)}
        unknown = set(kw) - set(fields)
        if unknown:
            raise TypeError(f"unknown PrecisionPlan field(s): {sorted(unknown)}")
        fields["mode"] = mode
        fields.update(kw)
        for name, value in fields.items():
            object.__setattr__(self, name, value)

    @property
    def s_sample(self) -> int:
        """Interval count of the sample channel (s = 2^bits − 1)."""
        return 2 ** self.sample_bits - 1

    def ds_config(self):
        """The DSConfig consumed by ``core.double_sampling`` (imported here:
        quant is the base layer and must not import core at module scope)."""
        from repro_torch.core.double_sampling import DSConfig

        return DSConfig(
            s_sample=self.s_sample,
            s_model=2 ** self.model_bits - 1 if self.model_bits else 0,
            s_grad=2 ** self.grad_bits - 1 if self.grad_bits else 0,
        )

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, d: dict) -> "PrecisionPlan":
        return cls(**d)

    @property
    def bits_sample(self) -> int:
        _warn_legacy("bits_sample", "sample_bits")
        return self.sample_bits

    @property
    def bits_model(self) -> int:
        _warn_legacy("bits_model", "model_bits")
        return self.model_bits

    @property
    def bits_grad(self) -> int:
        _warn_legacy("bits_grad", "grad_bits")
        return self.grad_bits

    @property
    def weight_bits(self) -> int:
        _warn_legacy("weight_bits", "model_bits")
        return self.model_bits

    @property
    def act_ds_bits(self) -> int:
        _warn_legacy("act_ds_bits", "act_bits")
        return self.act_bits

    @property
    def use_optimal_levels(self) -> bool:
        _warn_legacy("use_optimal_levels", "optimal_levels")
        return self.optimal_levels

    @property
    def weight_storage(self) -> str:
        _warn_legacy("weight_storage", "model_storage")
        return self.model_storage
