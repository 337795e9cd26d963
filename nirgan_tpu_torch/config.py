"""The experiment config, counterpart of ``nirgan_tpu/config.py``: the same
YAML schema (the upstream NIR-GAN configs plus the ``tpu:`` section), read
by the JAX package's own loader, which is numpy/yaml only."""

from nirgan_tpu.config import ConfigNode, load_config, tpu_section

__all__ = ["ConfigNode", "load_config", "tpu_section"]
