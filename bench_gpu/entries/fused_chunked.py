"""Entry: the chunked fused check of BASELINE config 5, as `bench.py
--chunks` drives it: per call `hash.tai_batch.hash_to_g1_device` over the
call's messages, a fresh `dist.batch_verify.random_weights`, then
`dist.batch_verify.verify_batch_fused_chunked(..., chunk=<chunk>)`.

The hash's candidates (`k_candidates`, 32 as bench.py --chunks passes) and
the weights' width (`rlc_bits`) are the configuration's, passed in; only the
kernels' unrolling is left to config.DEFAULT. Signatures and public keys are
converted to device form once, in set-up (`utils.convert`), as bench.py's
device fixture holds them. A call's verdict is the one bool of the whole
batch.
"""

from __future__ import annotations

# what the timed path takes from config.DEFAULT, which the configuration
# states
READS_DEFAULT = ("unroll_static_loops",)


class Caller:
    def __init__(self, cfg, data, device):
        import torch
        from bn254_tpu_torch.dist import batch_verify as BV
        from bn254_tpu_torch.hash import tai_batch as TB
        from bn254_tpu_torch.utils import convert as CV

        self.BV, self.TB = BV, TB
        self.device = torch.device(device)
        self.tuples = cfg["tuples"]
        self.chunk = cfg["chunk"]
        self.k = cfg["k_candidates"]
        self.bits = cfg["rlc_bits"]
        keys = [(x, y, (1, 0)) for x, y in data.public_keys]
        batches = []
        for b, ki in enumerate(data.key_index):
            pqx, pqy = CV.g2_batch_to_device_affine(
                [keys[i] for i in ki.tolist()], self.device)
            sx, sy = CV.g1_batch_to_device_affine(
                [(x, y, 1) for x, y in data.sigs[b]], self.device)
            batches.append((sx, sy, pqx, pqy))
        self.calls = []
        for e in data.entries:
            sx, sy, pqx, pqy = batches[e.batch]
            if len(e.bad_index):
                bx, by = CV.g1_batch_to_device_affine(
                    [(x, y, 1) for x, y in e.bad_sig], self.device)
                idx = torch.as_tensor(e.bad_index, device=self.device)
                sx, sy = (_replaced(a, idx, b) for a, b in ((sx, bx), (sy, by)))
            self.calls.append((data.messages[e.batch], sx, sy, pqx, pqy))
        self._expected = [bool(e.expected.all()) for e in data.entries]

    def call(self, i: int) -> bool:
        messages, sx, sy, pqx, pqy = self.calls[i % len(self.calls)]
        hx, hy = self.TB.hash_to_g1_device(messages, self.k, self.device)
        w = self.BV.random_weights(self.tuples, self.bits, self.device)
        return bool(self.BV.verify_batch_fused_chunked(
            hx, hy, sx, sy, pqx, pqy, w, chunk=self.chunk, nbits=self.bits))

    def expected(self, i: int) -> bool:
        return self._expected[i % len(self._expected)]


def _replaced(el, idx, new):
    """A copy of `el` with the columns `idx` taken from `new`."""
    from bn254_tpu_torch.fields import limbs as L

    arr = el.arr.clone()
    arr[:, idx] = new.arr
    return L.El(arr, max(el.vmax, new.vmax), max(el.lmax, new.lmax))
