"""Configuration system: the port's own copy of ``nirgan_tpu/config.py``
(the same YAML schema, the ``tpu:`` section included, so one config file
drives both packages).

A minimal, dependency-free mirror of the OmegaConf API surface that the
reference uses (``OmegaConf.load`` / ``OmegaConf.save`` / dot-access /
``in`` / ``dict(...)`` over sub-trees — see reference ``train.py:34-40``,
``model/pix2pix.py:20-21,69``, ``model/pix2pix.py:248``).

The three shipped YAML files under ``configs/`` keep the exact schema of the
reference configs (``configs/config_px2px.yaml``,
``configs/config_px2px_SatCLIP.yaml``, ``configs/config_baselines.yaml``) so
that a reference user's config edits carry over unchanged.  TPU-specific
settings live in an *additional* ``tpu:`` section which the reference schema
does not have; every key in it has a default so reference configs load as-is.
"""

from __future__ import annotations

import copy
from typing import Any, Iterator, Mapping

import yaml

__all__ = ["ConfigNode", "load_config", "save_config", "from_dict", "merge"]


class ConfigNode(Mapping):
    """Nested dot-accessible mapping (read/write), OmegaConf-style."""

    def __init__(self, data: dict | None = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self[k] = v

    # -- item access ------------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, Mapping) and not isinstance(value, ConfigNode):
            value = ConfigNode(dict(value))
        self._data[key] = value

    def __delitem__(self, key: str) -> None:
        del self._data[key]

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError:
            raise AttributeError(f"Config key not found: {key!r}")

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    # -- mapping protocol ---------------------------------------------------
    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def values(self):
        return self._data.values()

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_dict()!r})"

    def __deepcopy__(self, memo):
        return ConfigNode(copy.deepcopy(self.to_dict(), memo))

    # -- (de)serialisation ----------------------------------------------------
    def to_dict(self) -> dict:
        out = {}
        for k, v in self._data.items():
            out[k] = v.to_dict() if isinstance(v, ConfigNode) else v
        return out


def from_dict(data: dict) -> ConfigNode:
    return ConfigNode(data)


def load_config(path: str) -> ConfigNode:
    """Load a YAML config file into a dot-accessible tree.

    Mirrors ``OmegaConf.load`` at reference ``train.py:34-40``.
    """
    with open(path, "r") as f:
        data = yaml.safe_load(f) or {}
    return ConfigNode(data)


def save_config(cfg: ConfigNode | dict, path: str) -> None:
    """Persist a config tree (mirrors ``OmegaConf.save``; the reference
    snapshots the config into the experiment dir at epoch 1,
    ``model/pix2pix.py:321-324``)."""
    data = cfg.to_dict() if isinstance(cfg, ConfigNode) else cfg
    with open(path, "w") as f:
        yaml.safe_dump(data, f, sort_keys=False)


def merge(base: ConfigNode, override: Mapping) -> ConfigNode:
    """Recursive merge (override wins), OmegaConf.merge-style."""
    out = ConfigNode(base.to_dict())
    for k, v in override.items():
        if k in out and isinstance(out[k], ConfigNode) and isinstance(v, Mapping):
            out[k] = merge(out[k], v)
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# TPU-specific defaults (absent from the reference schema; applied lazily).
# ---------------------------------------------------------------------------

_TPU_DEFAULTS = {
    "mesh_axes": ["data"],
    # bf16 compute with f32 params/normalisation is the TPU-native default;
    # "float32" reproduces the reference numerics for parity testing.
    "compute_dtype": "bfloat16",
    "param_dtype": "float32",
    # static-shape buckets the predict API pads to (reference supports
    # arbitrary H×W because the nets are fully convolutional; XLA needs
    # static shapes, so we bucket — SURVEY.md §5.7).
    "shape_buckets": [256, 512],
    "donate_state": True,
}


def tpu_section(cfg: ConfigNode) -> ConfigNode:
    """Return cfg.tpu with defaults filled in (reference configs lack it)."""
    tpu = ConfigNode(copy.deepcopy(_TPU_DEFAULTS))
    if "tpu" in cfg:
        tpu = merge(tpu, cfg["tpu"])
    return tpu
