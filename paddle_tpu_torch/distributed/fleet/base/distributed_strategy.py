"""``DistributedStrategy``, the counterpart of
``paddle_tpu/distributed/fleet/base/distributed_strategy.py``: every
parallelism knob in one typed host object with Paddle's attribute
surface (``hybrid_configs``, ``amp``, ``recompute``, ``sharding``,
``gradient_merge``, ``lamb`` and their ``*_configs`` dicts, which update
in place), round-tripped as plain dicts.  The static meta-optimizer
reads its ``amp``, ``recompute``, ``gradient_merge`` and ``lamb`` parts;
the mesh degrees wait for the port's ``fleet`` (ROADMAP.md, Queue 1
item 8).
"""

from __future__ import annotations

import copy

_HYBRID_DEFAULTS = {
    "dp_degree": -1,   # -1: absorb remaining devices (reference semantics)
    "mp_degree": 1,
    "pp_degree": 1,
    "sharding_degree": 1,
    "sep_degree": 1,
    "order": ["dp", "pp", "sharding", "sep", "mp"],
}

_AMP_DEFAULTS = {
    "init_loss_scaling": 32768.0,
    "incr_every_n_steps": 1000,
    "decr_every_n_nan_or_inf": 2,
    "incr_ratio": 2.0,
    "decr_ratio": 0.5,
    "use_dynamic_loss_scaling": True,
    "use_pure_fp16": False,
    "use_fp16_guard": False,
    "use_bf16": True,  # the default half type: no loss scaling
    "custom_white_list": [],
    "custom_black_list": [],
}

_SHARDING_DEFAULTS = {
    "sharding_degree": 1,
    "stage": 1,
    "offload": False,
    "segment_broadcast_MB": 32.0,
}

_PIPELINE_DEFAULTS = {
    "accumulate_steps": 1,
    "micro_batch_size": 1,
    "enable_partial_send_recv": True,
    "schedule_mode": "1F1B",
}

_RECOMPUTE_DEFAULTS = {
    "checkpoints": [],
    "enable_offload": False,
}

_GRADIENT_MERGE_DEFAULTS = {
    "k_steps": 1,
    "avg": True,
}

_LAMB_DEFAULTS = {
    "lamb_weight_decay": 0.01,
    "exclude_from_weight_decay": [],
}


class DistributedStrategy:
    def __init__(self):
        self.amp = False
        self.recompute = False
        self.sharding = False
        self.gradient_merge = False
        self.lamb = False
        self.lars = False
        self.fuse_all_reduce_ops = True  # kept for API parity
        self.find_unused_parameters = False
        self.gradient_scale_configs = {"scale_strategy": "avg"}
        self._hybrid_configs = dict(_HYBRID_DEFAULTS)
        self._amp_configs = dict(_AMP_DEFAULTS)
        self._sharding_configs = dict(_SHARDING_DEFAULTS)
        self._pipeline_configs = dict(_PIPELINE_DEFAULTS)
        self._recompute_configs = dict(_RECOMPUTE_DEFAULTS)
        self._gradient_merge_configs = dict(_GRADIENT_MERGE_DEFAULTS)
        self._lamb_configs = dict(_LAMB_DEFAULTS)

    # -- config dicts keep reference update-in-place semantics ------------
    @property
    def hybrid_configs(self):
        return self._hybrid_configs

    @hybrid_configs.setter
    def hybrid_configs(self, cfg):
        unknown = set(cfg) - set(_HYBRID_DEFAULTS)
        if unknown:
            raise ValueError(f"unknown hybrid_configs keys: {sorted(unknown)}")
        self._hybrid_configs.update(cfg)

    @property
    def amp_configs(self):
        return self._amp_configs

    @amp_configs.setter
    def amp_configs(self, cfg):
        self._amp_configs.update(cfg)

    @property
    def sharding_configs(self):
        return self._sharding_configs

    @sharding_configs.setter
    def sharding_configs(self, cfg):
        self._sharding_configs.update(cfg)

    @property
    def pipeline_configs(self):
        return self._pipeline_configs

    @pipeline_configs.setter
    def pipeline_configs(self, cfg):
        self._pipeline_configs.update(cfg)

    @property
    def recompute_configs(self):
        return self._recompute_configs

    @recompute_configs.setter
    def recompute_configs(self, cfg):
        self._recompute_configs.update(cfg)

    @property
    def gradient_merge_configs(self):
        return self._gradient_merge_configs

    @gradient_merge_configs.setter
    def gradient_merge_configs(self, cfg):
        self._gradient_merge_configs.update(cfg)

    @property
    def lamb_configs(self):
        return self._lamb_configs

    @lamb_configs.setter
    def lamb_configs(self, cfg):
        self._lamb_configs.update(cfg)

    # -- helpers ----------------------------------------------------------
    def hybrid_degrees(self, n_devices):
        """Resolve degrees, absorbing remaining devices into dp_degree=-1."""
        h = self._hybrid_configs
        known = (h["mp_degree"] * h["pp_degree"] * h["sharding_degree"]
                 * h["sep_degree"])
        dp = h["dp_degree"]
        if dp in (-1, None):
            if n_devices % known:
                raise ValueError(f"{n_devices} devices not divisible by "
                                 f"mp*pp*sharding*sep={known}")
            dp = n_devices // known
        if dp * known != n_devices:
            raise ValueError(
                f"hybrid degrees {dp}*{known} != device count {n_devices}")
        return {"dp": dp, "mp": h["mp_degree"], "pp": h["pp_degree"],
                "sharding": h["sharding_degree"], "sep": h["sep_degree"]}

    def to_dict(self):
        return {
            "amp": self.amp, "recompute": self.recompute,
            "sharding": self.sharding,
            "hybrid_configs": copy.deepcopy(self._hybrid_configs),
            "amp_configs": copy.deepcopy(self._amp_configs),
            "sharding_configs": copy.deepcopy(self._sharding_configs),
            "pipeline_configs": copy.deepcopy(self._pipeline_configs),
            "recompute_configs": copy.deepcopy(self._recompute_configs),
            "gradient_merge": self.gradient_merge,
            "gradient_merge_configs": copy.deepcopy(
                self._gradient_merge_configs),
            "lamb": self.lamb,
            "lamb_configs": copy.deepcopy(self._lamb_configs),
        }

    def __repr__(self):
        import json

        return "DistributedStrategy(" + json.dumps(self.to_dict(), indent=2,
                                                   default=str) + ")"
