"""Entry: `bn254_tpu_torch.api.batch_verify(messages, signatures,
public_keys, mode=<config's mode>)`, as a user calls it.

Signatures and public keys are handed over as host points (objects with a
`.point`, Jacobian with Z = 1, as the codec decodes them), so each call
pays the API's hash, host conversions and weight draw. A call's verdict is
the per-tuple bool array the API returns.
"""

from __future__ import annotations

import numpy as np

# what the API takes from config.DEFAULT, which the configuration states
READS_DEFAULT = ("k_candidates", "rlc_bits", "glv_weights",
                 "unroll_static_loops")


class HostPoint:
    """What the API reads of a Signature or a PublicKey."""

    __slots__ = ("point",)

    def __init__(self, point):
        self.point = point


class Caller:
    def __init__(self, cfg, data, device):
        from bn254_tpu_torch import api

        self.api = api
        self.mode = cfg["mode"]
        self.device = device
        self.tuples = cfg["tuples"]
        keys = [HostPoint((x, y, (1, 0))) for x, y in data.public_keys]
        self.calls = []
        for e in data.entries:
            sigs = [HostPoint((x, y, 1)) for x, y in data.sigs_of(e)]
            pks = [keys[i] for i in data.key_index[e.batch].tolist()]
            self.calls.append((data.messages[e.batch], sigs, pks))
        self._expected = [e.expected for e in data.entries]

    def call(self, i: int) -> np.ndarray:
        messages, sigs, pks = self.calls[i % len(self.calls)]
        return np.asarray(self.api.batch_verify(messages, sigs, pks,
                                                mode=self.mode,
                                                device=self.device))

    def expected(self, i: int) -> np.ndarray:
        return self._expected[i % len(self._expected)]
