"""Entry: BASELINE config 5 across the cards of one host, in the layout of
`bench.py --mode sharded`: one process a rank, a card each, every rank on
the same full batch (the SPMD contract of
`dist.batch_verify.make_sharded_verifier`), at the hash width and the chunk
a chip of `bench.py --chunks` (the configuration's `departures`).

Set-up, on every rank: the full batch converted to device form once, as
`fused_chunked` does; the rank joins the port's process group through
`dist.mesh.initialize` with the `RankInfo` the harness gives it, and builds
`run = make_sharded_verifier(make_mesh())`. A call, on every rank:
`hash_to_g1_device` over the call's messages, the rank's own full-batch
`random_weights` (not the one draw that the contract asks every rank to
pass: the configuration's `assumed.weights` says why the check stays
sound), then `run(..., w, chunk=<chunk>)`: each chunk's shard of this
rank, one Fq12 all-reduce, one final exponentiation. A call's verdict
is the one bool of the whole batch, the same on every rank.
"""

from __future__ import annotations

from bench_gpu import spec

# what the timed path takes from config.DEFAULT, which the configuration
# states
READS_DEFAULT = ("unroll_static_loops",)


class Caller(spec.entry("fused_chunked").Caller):
    def __init__(self, cfg, data, device, rank):
        from bn254_tpu_torch.dist import mesh as MESH

        super().__init__(cfg, data, device)
        MESH.initialize(coordinator_address=rank.address,
                        num_processes=rank.world, process_id=rank.rank,
                        timeout=rank.timeout_s, device=self.device,
                        backend=rank.backend)
        self.run = self.BV.make_sharded_verifier(
            MESH.make_mesh(device=self.device))

    def call(self, i: int) -> bool:
        messages, sx, sy, pqx, pqy = self.calls[i % len(self.calls)]
        hx, hy = self.TB.hash_to_g1_device(messages, self.k, self.device)
        w = self.BV.random_weights(self.tuples, self.bits, self.device)
        return bool(self.run(hx, hy, sx, sy, pqx, pqy, w, chunk=self.chunk))

    def close(self) -> None:
        """Leave the process group."""
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
