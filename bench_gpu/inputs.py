"""A cell's tuples and their verdicts, made from the seed by the reference.

The benchmark makes its inputs itself (`reference/bls.py`), never with the
program: `keys` secret keys and their public keys, `distinct_batches`
batches of `tuples` (message, signature, key index) made from the seed, and
for each entry of the traffic's `rotation` (the calls, in turn) the batch it
sends with `invalid` signatures replaced at seeded indices by the right key's
signature over another message, drawn from the part of the batch that the
entry's `within` names ([start, end) as shares of it; all of it by
default). Each entry's verdicts are worked out by the BLS relation: a tuple
is valid when its signature is [sk]H(m).

Making them costs seconds of host time, spread over a pool of processes, so
they are kept in `cache/` under a name made of the cell, the seed and a
digest of everything that shapes them; a later run of the same seed loads
them.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import multiprocessing
import os
from pathlib import Path

import numpy as np

from .reference import bls

HERE = Path(__file__).resolve().parent
CACHE = HERE / "cache"
FORMAT = 1  # bump when the layout below changes
_PARALLEL_FROM = 512  # tuples below which the pool costs more than it saves


@dataclasses.dataclass
class Entry:
    """One call's inputs: a batch, with some signatures replaced."""

    batch: int
    bad_index: np.ndarray  # (k,) int64
    bad_sig: list  # k affine points
    expected: np.ndarray  # (tuples,) bool, the reference's verdicts


@dataclasses.dataclass
class Inputs:
    messages: list  # per batch: list of bytes
    key_index: list  # per batch: (tuples,) int64
    sigs: list  # per batch: list of affine G1 points (x, y)
    public_keys: list  # affine G2 points ((x0, x1), (y0, y1))
    entries: list  # one Entry per rotation entry
    secret_keys: list  # the reference's own; the program never sees them

    def sigs_of(self, e: Entry) -> list:
        """The entry's signatures: its batch's, with the bad ones in."""
        sigs = list(self.sigs[e.batch])
        for i, s in zip(e.bad_index.tolist(), e.bad_sig):
            sigs[i] = s
        return sigs


def _sign_chunk(messages, sks):
    return [bls.sign(m, k) for m, k in zip(messages, sks)]


def _sign_all(messages, sks):
    """[sk]H(m) for every pair, on a pool of processes when it pays."""
    if len(messages) < _PARALLEL_FROM:
        return _sign_chunk(messages, sks)
    workers = min(8, os.cpu_count() or 1)
    step = -(-len(messages) // (4 * workers))
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        parts = [ex.submit(_sign_chunk, messages[i:i + step], sks[i:i + step])
                 for i in range(0, len(messages), step)]
        return [s for f in parts for s in f.result()]


def make(cfg: dict, traffic: dict, seed: int) -> Inputs:
    """The cell's inputs for `seed`, made by the reference."""
    rng = np.random.default_rng(seed % (1 << 64))
    n, mlen = cfg["tuples"], traffic["message_bytes"]
    # every key has its top bit set: the same ladder length on every seed
    top = 1 << (cfg["key_bits"] - 1)
    sks = [top | int.from_bytes(rng.bytes(8), "big") % top
           for _ in range(cfg["keys"])]
    public_keys = [bls.public_key(k) for k in sks]

    messages, key_index = [], []
    for _ in range(traffic["distinct_batches"]):
        raw = rng.bytes(n * mlen)
        messages.append([raw[i * mlen:(i + 1) * mlen] for i in range(n)])
        key_index.append(rng.integers(0, cfg["keys"], n))
    plan = []  # (entry, bad indices, other messages)
    for e in traffic["rotation"]:
        lo, hi = (int(f * n) for f in e.get("within", (0, 1)))
        bad = np.sort(lo + rng.choice(hi - lo, e["invalid"], replace=False))
        plan.append((e["batch"], bad, [rng.bytes(mlen) for _ in bad]))

    jobs_m = [m for ms in messages for m in ms]
    jobs_k = [sks[i] for ki in key_index for i in ki.tolist()]
    for b, bad, others in plan:
        jobs_m += others
        jobs_k += [sks[key_index[b][i]] for i in bad.tolist()]
    signed = _sign_all(jobs_m, jobs_k)
    sigs = [signed[i * n:(i + 1) * n] for i in range(len(messages))]
    pos = len(messages) * n
    entries = []
    for b, bad, others in plan:
        bad_sig = signed[pos:pos + len(bad)]
        pos += len(bad)
        replaced = dict(zip(bad.tolist(), bad_sig))
        # the BLS verdict given sk: sig == [sk]H(m), and sigs[b][i] is
        # [sk]H(m_i) itself
        expected = np.array([replaced.get(i, s) == s
                             for i, s in enumerate(sigs[b])])
        entries.append(Entry(b, bad.astype(np.int64), bad_sig, expected))
    return Inputs(messages, key_index, sigs, public_keys, entries, sks)


# -- the cache -------------------------------------------------------------


def _to_bytes(vals) -> np.ndarray:
    """Ints < 2^256 -> (len, 32) uint8, big-endian."""
    return np.frombuffer(b"".join(int(v).to_bytes(32, "big") for v in vals),
                         dtype=np.uint8).reshape(len(vals), 32)


def _from_bytes(arr: np.ndarray) -> list[int]:
    """(len, 32) uint8, big-endian -> ints."""
    raw = np.ascontiguousarray(arr).tobytes()
    return [int.from_bytes(raw[i:i + 32], "big")
            for i in range(0, len(raw), 32)]


def _g1(points) -> np.ndarray:
    return _to_bytes([c for p in points for c in p]).reshape(len(points), 2, 32)


def _g1_back(arr: np.ndarray) -> list:
    flat = _from_bytes(arr.reshape(-1, 32))
    return list(zip(flat[0::2], flat[1::2]))


def _save(inputs: Inputs, path: Path) -> None:
    arrays = {
        "messages": np.stack([np.frombuffer(b"".join(ms), dtype=np.uint8)
                              for ms in inputs.messages]),
        "key_index": np.stack(inputs.key_index),
        "sigs": np.stack([_g1(s) for s in inputs.sigs]),
        "public_keys": _to_bytes([c for (x, y) in inputs.public_keys
                                  for c in (*x, *y)]),
        "secret_keys": _to_bytes(inputs.secret_keys),
    }
    for j, e in enumerate(inputs.entries):
        arrays[f"e{j}_batch"] = np.array(e.batch)
        arrays[f"e{j}_bad_index"] = e.bad_index
        arrays[f"e{j}_bad_sig"] = _g1(e.bad_sig).reshape(-1, 2, 32)
        arrays[f"e{j}_expected"] = e.expected
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _load(path: Path, n_entries: int, mlen: int) -> Inputs:
    with np.load(path) as z:
        messages = [[bytes(r) for r in batch.reshape(-1, mlen)]
                    for batch in z["messages"]]
        key_index = [k.astype(np.int64) for k in z["key_index"]]
        sigs = [_g1_back(s) for s in z["sigs"]]
        c = _from_bytes(z["public_keys"])
        public_keys = [((c[i], c[i + 1]), (c[i + 2], c[i + 3]))
                       for i in range(0, len(c), 4)]
        entries = [Entry(int(z[f"e{j}_batch"]),
                         z[f"e{j}_bad_index"].astype(np.int64),
                         _g1_back(z[f"e{j}_bad_sig"]),
                         z[f"e{j}_expected"].astype(bool))
                   for j in range(n_entries)]
        sks = _from_bytes(z["secret_keys"])
    return Inputs(messages, key_index, sigs, public_keys, entries, sks)


def _digest(cfg: dict, traffic: dict) -> str:
    h = hashlib.sha256(json.dumps([FORMAT, cfg, traffic], sort_keys=True)
                       .encode())
    for src in (HERE / "reference" / "bls.py", Path(__file__)):
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _path(workload: str, cfg: dict, traffic: dict, seed: int,
          cache: Path) -> Path:
    return cache / f"{workload}-{seed}-{_digest(cfg, traffic)}.npz"


def ensure(workload: str, cfg: dict, traffic: dict, seed: int,
           cache: Path = CACHE) -> bool:
    """Make the cell's inputs for `seed` and store them in the cache,
    unless they are there; True if they were made."""
    path = _path(workload, cfg, traffic, seed, cache)
    if path.exists():
        return False
    _save(make(cfg, traffic, seed), path)
    return True


def load(workload: str, cfg: dict, traffic: dict, seed: int,
         cache: Path = CACHE) -> Inputs:
    """The cell's inputs for `seed`, from the cache (see `ensure`)."""
    return _load(_path(workload, cfg, traffic, seed, cache),
                 len(traffic["rotation"]), traffic["message_bytes"])
