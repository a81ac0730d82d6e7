"""ctypes binding of the native host core, `csrc/bn254_host.cpp`.

The C++ library does the host-side math natively: scalar muls, adds,
pairings, pairing products, hash-to-G1, sign and verify, and the curve
and subgroup predicates, the role the reference gives its Rust math
dependency. The pure-Python modules of this package stay the oracle:
`host/curve.py` and `host/pairing.py` dispatch here when `available()`,
and their `*_py` functions never do.

The source is the one the JAX package binds, compiled in place and
unedited. At first use (never at import) g++, or `$CXX`, builds it with
the flags of `csrc/Makefile` into `bn254_tpu_torch/kernels/_build/`,
named by a digest of the source and the flags (`kernels/build.py`'s
`digest_path` and `compile_all`: a temporary file, then an atomic
replace); an fcntl lock on a file beside it makes concurrent processes
on a fresh tree compile once while the rest wait.

`available()` is False only when BN254_DISABLE_NATIVE is set or no C++
compiler is on PATH; the callers then take the oracle. A compiler that is
present but refuses the source, or a library that does not load, raises
`KernelBuildError` with the compiler's output: there is no silent
fallback. `calls` counts each function's calls into the library.

All byte interfaces are big-endian 32-byte field elements; G1 = x||y,
G2 = x.re||x.im||y.re||y.im (the reference's uncompressed layout). The
wrappers take and return affine int tuples with None as the identity;
scalars at or above R are not reduced (the subgroup check relies on a
genuine [R]P).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import threading
from pathlib import Path

from ..kernels import build

SRC = Path(__file__).resolve().parents[2] / "csrc" / "bn254_host.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-fno-exceptions")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_int, _u64 = ctypes.c_int, ctypes.c_uint64
# the C ABI: each export `bn254_<name>`'s argument types (every one
# returns int)
_SIGNATURES = {
    "g1_mul": (_u8p, _int, _u8p, _u8p),
    "g2_mul": (_u8p, _int, _u8p, _u8p),
    "g1_add": (_u8p, _int, _u8p, _int, _u8p),
    "g2_add": (_u8p, _int, _u8p, _int, _u8p),
    "pairing": (_u8p, _int, _u8p, _int, _u8p),
    "pairing_check": (_u8p, _u8p, _u8p, _u64),
    "pairing_product": (_u8p, _u8p, _u8p, _u64, _u8p),
    "hash_to_g1": (_u8p, _u64, _u8p),
    "sign": (_u8p, _u64, _u8p, _u8p),
    "verify": (_u8p, _u64, _u8p, _int, _u8p, _int),
    "g2_y_from_x": (_u8p, _u8p),
    "g2_in_subgroup": (_u8p,),
    "g1_on_curve": (_u8p,),
    "g2_on_curve": (_u8p,),
}

# each wrapper's calls into the library in this process (g2_y_from_x is
# bound without a wrapper, as in the JAX package)
calls = dict.fromkeys((n for n in _SIGNATURES if n != "g2_y_from_x"), 0)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def compiler() -> str | None:
    """The C++ compiler the core builds with ($CXX, else g++), or None
    when it is not on PATH."""
    return shutil.which(os.environ.get("CXX") or "g++")


def available() -> bool:
    """Whether the host paths take the core: not under
    BN254_DISABLE_NATIVE, and a C++ compiler is on PATH."""
    return (not os.environ.get("BN254_DISABLE_NATIVE")
            and compiler() is not None)


def output() -> Path:
    """The library file of the core (digest of the source and the flags)."""
    return build.digest_path(SRC, CXX_FLAGS)


def library() -> ctypes.CDLL:
    """The loaded core, compiled on first use (once across processes).
    Raises KernelBuildError when there is no compiler, the compiler
    refuses the source or the library does not load."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = output()
        if not out.exists():
            cxx = compiler()
            if cxx is None:
                raise build.KernelBuildError(
                    f"no C++ compiler ({os.environ.get('CXX') or 'g++'}) on "
                    "PATH to build the native host core")
            out.parent.mkdir(parents=True, exist_ok=True)
            with open(out.with_suffix(".lock"), "w") as fh:
                fcntl.flock(fh, fcntl.LOCK_EX)  # released when fh closes
                if not out.exists():
                    build.compile_all([("bn254_host", [cxx, *CXX_FLAGS],
                                        SRC, out)])
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            raise build.KernelBuildError(
                f"cannot load the native host core {out}: {e}") from e
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, f"bn254_{name}")
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _lib = lib
        return lib


def _call(name: str, *args) -> int:
    """bn254_<name>(*args), counted."""
    lib = library()
    calls[name] += 1
    return getattr(lib, f"bn254_{name}")(*args)


def _buf(b: bytes):
    """A C copy of `b` (one byte at least: a pointer to an empty message
    must still be valid)."""
    return ctypes.cast((ctypes.c_uint8 * max(len(b), 1)).from_buffer_copy(
        b or b"\0"), _u8p)


def _out(n: int):
    return (ctypes.c_uint8 * n)()


# ---- affine tuple <-> bytes (ints, None = identity) ----


def _g1_bytes(aff) -> tuple[bytes, int]:
    if aff is None:
        return bytes(64), 1
    return aff[0].to_bytes(32, "big") + aff[1].to_bytes(32, "big"), 0


def _g1_from(buf, inf: int):
    if inf:
        return None
    raw = bytes(buf)
    return int.from_bytes(raw[:32], "big"), int.from_bytes(raw[32:], "big")


def _g2_bytes(aff) -> tuple[bytes, int]:
    if aff is None:
        return bytes(128), 1
    (x0, x1), (y0, y1) = aff
    return b"".join(c.to_bytes(32, "big") for c in (x0, x1, y0, y1)), 0


def _g2_from(buf, inf: int):
    if inf:
        return None
    raw = bytes(buf)
    c = [int.from_bytes(raw[i * 32:(i + 1) * 32], "big") for i in range(4)]
    return (c[0], c[1]), (c[2], c[3])


def _fq12_from(buf):
    """The oracle's nested Fq12 layout of 12 big-endian coefficients
    c0.c0 (re, im), c0.c1, c0.c2, c1.c0, c1.c1, c1.c2."""
    raw = bytes(buf)
    cs = [int.from_bytes(raw[i * 32:(i + 1) * 32], "big") for i in range(12)]
    f = [(cs[2 * i], cs[2 * i + 1]) for i in range(6)]
    return (f[0], f[1], f[2]), (f[3], f[4], f[5])


def _pairs_bytes(pairs):
    """The G1 bytes, G2 bytes and identity flags (1: P, 2: Q) of affine
    (g1, g2) pairs."""
    ps, qs, infs = bytearray(), bytearray(), bytearray()
    for g1a, g2a in pairs:
        r1, i1 = _g1_bytes(g1a)
        r2, i2 = _g2_bytes(g2a)
        ps += r1
        qs += r2
        infs.append(i1 | (2 if i2 else 0))
    return _buf(bytes(ps)), _buf(bytes(qs)), _buf(bytes(infs))


# ---- public wrappers (affine int tuples; None = identity) ----


def g1_mul(aff, k: int):
    """[k]P for 0 <= k < 2^256 (k is not reduced mod R)."""
    raw, inf = _g1_bytes(aff)
    out = _out(64)
    r = _call("g1_mul", _buf(raw), inf,
              _buf((k % (1 << 256)).to_bytes(32, "big")), out)
    return _g1_from(out, r)


def g2_mul(aff, k: int):
    """[k]Q for 0 <= k < 2^256 (k is not reduced mod R)."""
    raw, inf = _g2_bytes(aff)
    out = _out(128)
    r = _call("g2_mul", _buf(raw), inf,
              _buf((k % (1 << 256)).to_bytes(32, "big")), out)
    return _g2_from(out, r)


def g1_add(a, b):
    ra, ia = _g1_bytes(a)
    rb, ib = _g1_bytes(b)
    out = _out(64)
    r = _call("g1_add", _buf(ra), ia, _buf(rb), ib, out)
    return _g1_from(out, r)


def g2_add(a, b):
    ra, ia = _g2_bytes(a)
    rb, ib = _g2_bytes(b)
    out = _out(128)
    r = _call("g2_add", _buf(ra), ia, _buf(rb), ib, out)
    return _g2_from(out, r)


def hash_to_g1(msg: bytes):
    """The affine try-and-increment hash point, or None if all 255
    counters fail."""
    out = _out(64)
    if _call("hash_to_g1", _buf(msg), len(msg), out) < 0:
        return None
    return _g1_from(out, 0)


def sign(msg: bytes, sk: int):
    """The affine signature H(m)·sk, or None if hashing fails."""
    out = _out(64)
    if _call("sign", _buf(msg), len(msg),
             _buf(sk.to_bytes(32, "big")), out) < 0:
        return None
    return _g1_from(out, 0)


def verify(msg: bytes, sig_aff, pk_aff) -> bool:
    """e(H(m), PK) · e(sig, -G2) == 1."""
    rs, is_ = _g1_bytes(sig_aff)
    rp, ip = _g2_bytes(pk_aff)
    r = _call("verify", _buf(msg), len(msg), _buf(rs), is_,
              _buf(rp), ip)
    if r < 0:
        raise RuntimeError("hash-to-G1 failed")
    return bool(r)


def pairing_check(pairs) -> bool:
    """prod e(P, Q) == 1 over affine (g1, g2) pairs."""
    return bool(_call("pairing_check", *_pairs_bytes(pairs), len(pairs)))


def pairing_product(pairs):
    """prod e(P, Q) over affine (g1, g2) pairs with one shared final
    exponentiation, as a canonical Fq12 in the oracle's layout."""
    out = _out(384)
    _call("pairing_product", *_pairs_bytes(pairs), len(pairs), out)
    return _fq12_from(out)


def pairing(g1_aff, g2_aff):
    """e(P, Q) as a canonical Fq12 in the oracle's layout."""
    r1, i1 = _g1_bytes(g1_aff)
    r2, i2 = _g2_bytes(g2_aff)
    out = _out(384)
    _call("pairing", _buf(r1), i1, _buf(r2), i2, out)
    return _fq12_from(out)


def g2_in_subgroup(aff) -> bool:
    """[R]Q == identity (the identity is in the subgroup)."""
    raw, inf = _g2_bytes(aff)
    return bool(inf) or bool(_call("g2_in_subgroup", _buf(raw)))


def g1_on_curve(aff) -> bool:
    raw, inf = _g1_bytes(aff)
    return bool(inf) or bool(_call("g1_on_curve", _buf(raw)))


def g2_on_curve(aff) -> bool:
    raw, inf = _g2_bytes(aff)
    return bool(inf) or bool(_call("g2_on_curve", _buf(raw)))
