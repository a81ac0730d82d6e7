"""Configuration of the batch-verification pipeline.

The knobs this package honours: the hash-search width, the RLC weight
width, the weight form, the loop form, and the process-group settings of
the sharded verifier (dist/mesh.py). Environment variables give the
defaults (`Config.from_env`), explicit overrides win. There is no switch
that turns the CUDA kernels off: a CUDA tensor always goes through them.
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

    # Unroll the Miller loop, exp_u, the fixed powers and the GLV ladder
    # over their STATIC schedules on the card (one fused kernel per digit,
    # window or step; the independent tier through pair2). False runs
    # their scan forms there: the Miller loop through the per-op kernels
    # fq12_sq, g2_dbl_step, g2_add_step and fq12_mul_line, exp_u through
    # the standalone Fq12 ops, the powers and the ladder leaf by leaf, the
    # independent tier stacked. Read at each dispatch site from DEFAULT
    # only (as in the JAX package): set it with BN254_DISABLE_UNROLL or by
    # replacing DEFAULT; `api` refuses a passed config that differs here.
    unroll_static_loops: bool = True

    # mesh axis name used by the sharded verifier and collectives.
    axis_name: str = "batch"

    # multi-process (torch.distributed) settings; None = single-process.
    # `dist.mesh.initialize` starts a process group at tcp://<address>.
    coordinator_address: str | None = None
    num_processes: int = 1
    process_id: int = 0

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
        if os.environ.get("BN254_DISABLE_UNROLL"):
            env["unroll_static_loops"] = False
        if os.environ.get("BN254_COORDINATOR"):
            env["coordinator_address"] = os.environ["BN254_COORDINATOR"]
            env["num_processes"] = int(os.environ.get("BN254_NUM_PROCESSES", "1"))
            env["process_id"] = int(os.environ.get("BN254_PROCESS_ID", "0"))
        env.update(overrides)
        return cls(**env)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT = Config.from_env()
