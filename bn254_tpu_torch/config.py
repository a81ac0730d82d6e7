"""Configuration of the batch-verification pipeline.

The knobs this package honours: the hash-search width, the RLC weight
width and the weight form. Environment variables give the defaults
(`Config.from_env`), explicit overrides win. There is no switch that
turns the CUDA kernel off: a CUDA tensor always goes through it.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Config:
    """Knobs for the batched verification pipeline."""

    # hash-to-G1: device candidate counters per message; a message whose
    # K candidates all miss (probability ~2^-K) is hashed on the host.
    k_candidates: int = 8

    # random-linear-combination weight width (bits) for fused batch
    # verification; a forgery slips through with probability ~2^-bits.
    rlc_bits: int = 128

    # draw RLC weights in GLV form w = a + λb (curve/glv.py): the same
    # ~2^-rlc_bits soundness with half the weight-ladder steps.
    glv_weights: bool = True

    @classmethod
    def from_env(cls, **overrides) -> "Config":
        """Defaults from the environment, then explicit overrides."""
        env = {}
        if os.environ.get("BN254_K_CANDIDATES"):
            env["k_candidates"] = int(os.environ["BN254_K_CANDIDATES"])
        if os.environ.get("BN254_RLC_BITS"):
            env["rlc_bits"] = int(os.environ["BN254_RLC_BITS"])
        if os.environ.get("BN254_DISABLE_GLV"):
            env["glv_weights"] = False
        env.update(overrides)
        return cls(**env)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT = Config.from_env()
