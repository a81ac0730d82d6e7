"""Level schedules of the lane-cooperative kernels of `fused.cu`.

Every fused kernel but the two pow windows (`miller_dbl_body`,
`miller_add_body`, `expu_step`, `expu_sq2`, `fq12_mul`, `fq12_cyc_sq`,
`miller_dbl_body2`, `miller_add_body2`, `glv_dbl_add`, `fq12_mul_line`,
`fq12_sq`, `g2_dbl_step` and `g2_add_step`) runs as a group of G threads
per lane (`fused.cu`, "Design"). Their bodies are traced here, Fp
operation by Fp operation, from formulas that mirror the plain bodies
(`fields/tower.py:fq2_mul, fq2_sq, fq6_mul, _fq12_mul_impl, _fq12_sq_impl,
_fq12_cyc_sq_impl`, `pairing/miller.py:_dbl_step_impl, _add_step_impl,
_fq12_mul_line_impl, _dbl_body2_impl`, `curve/jacobian.py:double, add`),
and cut into *levels*: sets of operations that read only what earlier
levels wrote. The group runs a level with thread g taking operations g,
g + G, ... and synchronises between levels.

An operation (`Op`) is one of

* LOAD: input El `a` of the lane, carried and brought into [0, 2p) by one
  CIOS product with R mod p;
* MUL: the CIOS product of the values in slots `a` and `b`;
* LIN: a chain of additions on one accumulator, `b` steps from `steps[a]`:
  SET s (acc = slot s), ZERO (acc = 0), ADD s (acc + s), SUB s (acc - s),
  RSUB s (s - acc), DBL (acc + acc), each result brought below 2p with
  limbs below 2^15 (`fp_fold_2p`). A chain absorbs every linear
  intermediate that only one later linear operation reads, so a level of
  additions is one short loop per thread;
* SEL: a chain of masked selects, `b` steps from `steps[a]`: IF_ZERO s and
  IF_NONZERO s test whether slot s is zero mod p (`fp_is_zero`: a value
  in [0, 2p)), and a take (TAKE s, TAKE_ZERO, TAKE_ONE: the Montgomery
  one) replaces acc on lanes where every test since the previous take
  holds. The first step is a take. `glv_dbl_add` ends in one SEL per
  output coordinate: the complete addition's four selects in the plain
  body's order.

Its result goes to slot `out` (if anything reads it later) and, canonical,
to output El `gout` (if it is one). Slots hold one Fp each in a lane's
shared memory, as 9 words of two 15-bit limbs, and are reused once their
last reader's level is over. Within a level the products come first, so a
warp runs its CIOS rounds without diverging.

The tables are generated into `coop_schedule.cuh`:

    python -m bn254_tpu_torch.kernels.coop_schedule

and `tests/test_torch_coop.py` checks that the header is current and that
every level reads only slots written by earlier levels.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

HEADER = Path(__file__).resolve().parent / "coop_schedule.cuh"

# op kinds, chain step codes and select step codes (fused.cu reads the
# same numbers)
MUL, LOAD, LIN, SEL = 0, 1, 2, 3
SET, ADD, SUB, RSUB, ZERO, DBL = range(6)
TAKE, TAKE_ZERO, TAKE_ONE, IF_ZERO, IF_NONZERO = range(5)
NONE = 0xFFFF
SLOT_BITS = 13  # slots < 2^13; step = code << 13 | slot
WORDS_PER_FP = 9  # 18 limbs of 15 bits, two to a 32-bit word


@dataclasses.dataclass(eq=False)
class Node:
    id: int
    op: str  # "load", "zero", "mul", "add", "sub", "sel"
    # Nodes; (input index,) for a load; (code, Node or None) steps for a sel
    args: tuple

    def operands(self):
        """The Nodes this one reads."""
        if self.op == "sel":
            return [x for _, x in self.args if x is not None]
        return [a for a in self.args if isinstance(a, Node)]


class Trace:
    """Fp operations of one body, in program order; identical operations
    on identical operands are one node."""

    def __init__(self):
        self.nodes: list[Node] = []
        self._memo: dict = {}

    def _node(self, op, *args):
        key = (op, tuple(a.id if isinstance(a, Node) else ("i", a)
                         for a in args))
        if key not in self._memo:
            self._memo[key] = Node(len(self.nodes), op, args)
            self.nodes.append(self._memo[key])
        return self._memo[key]

    def load(self, i):
        return self._node("load", i)

    def zero(self):
        return self._node("zero")

    def add(self, a, b):
        return self._node("add", a, b)

    def sub(self, a, b):
        return self._node("sub", a, b)

    def mul(self, a, b):
        return self._node("mul", a, b)

    def select(self, steps):
        """A SEL chain: [(code, Node or None)] (codes TAKE ... IF_NONZERO)."""
        return self._node("sel", *steps)


# -- the formulas of the plain bodies, over (c0, c1) / (c0, c1, c2) tuples


class Tower:
    def __init__(self, tr: Trace):
        self.t = tr

    def mul_small(self, a, k):
        t = self.t
        x2 = t.add(a, a)
        if k == 3:
            return t.add(x2, a)
        x4 = t.add(x2, x2)
        if k == 4:
            return x4
        x8 = t.add(x4, x4)
        if k == 8:
            return x8
        return t.add(x8, a)  # k == 9

    def fq2_add(self, a, b):
        return (self.t.add(a[0], b[0]), self.t.add(a[1], b[1]))

    def fq2_sub(self, a, b):
        return (self.t.sub(a[0], b[0]), self.t.sub(a[1], b[1]))

    def fq2_neg(self, a):
        z = self.t.zero()
        return (self.t.sub(z, a[0]), self.t.sub(z, a[1]))

    def fq2_double(self, a):
        return self.fq2_add(a, a)

    def fq2_mul_small(self, a, k):
        return (self.mul_small(a[0], k), self.mul_small(a[1], k))

    def fq2_mul(self, a, b):
        t = self.t
        sa, sb = t.add(a[0], a[1]), t.add(b[0], b[1])
        t0, t1, t2 = t.mul(a[0], b[0]), t.mul(a[1], b[1]), t.mul(sa, sb)
        r0 = t.sub(t0, t1)
        t2 = t.sub(t2, t0)
        return (r0, t.sub(t2, t1))

    def fq2_sq(self, a):
        t = self.t
        s, d, a1x2 = t.add(a[0], a[1]), t.sub(a[0], a[1]), t.add(a[1], a[1])
        r1 = t.mul(a[0], a1x2)
        return (t.mul(s, d), r1)

    def fq2_mul_fp(self, a, s):
        return (self.t.mul(a[0], s), self.t.mul(a[1], s))

    def fq2_mul_xi(self, a):
        t = self.t
        n0, n1 = self.mul_small(a[0], 9), self.mul_small(a[1], 9)
        n1 = t.add(a[0], n1)
        return (t.sub(n0, a[1]), n1)

    def fq6_add(self, a, b):
        return tuple(self.fq2_add(x, y) for x, y in zip(a, b))

    def fq6_sub(self, a, b):
        return tuple(self.fq2_sub(x, y) for x, y in zip(a, b))

    def fq6_mul_by_v(self, a):
        return (self.fq2_mul_xi(a[2]), a[0], a[1])

    def fq6_mul(self, a, b):
        m, add, sub, xi = self.fq2_mul, self.fq2_add, self.fq2_sub, self.fq2_mul_xi
        t0, t1, t2 = m(a[0], b[0]), m(a[1], b[1]), m(a[2], b[2])
        u0 = m(add(a[1], a[2]), add(b[1], b[2]))
        u1 = m(add(a[0], a[1]), add(b[0], b[1]))
        u2 = m(add(a[0], a[2]), add(b[0], b[2]))
        c0 = add(t0, xi(sub(sub(u0, t1), t2)))
        c1 = add(sub(sub(u1, t0), t1), xi(t2))
        c2 = add(sub(sub(u2, t0), t2), t1)
        return (c0, c1, c2)

    def fq12_mul(self, a, b):
        t0, t1 = self.fq6_mul(a[0], b[0]), self.fq6_mul(a[1], b[1])
        s = self.fq6_mul(self.fq6_add(a[0], a[1]), self.fq6_add(b[0], b[1]))
        c1 = self.fq6_sub(self.fq6_sub(s, t0), t1)
        return (self.fq6_add(t0, self.fq6_mul_by_v(t1)), c1)

    def fq12_sq(self, a):
        t = self.fq6_mul(a[0], a[1])
        x = self.fq6_add(a[0], a[1])
        y = self.fq6_add(a[0], self.fq6_mul_by_v(a[1]))
        u = self.fq6_sub(self.fq6_mul(x, y), t)
        return (self.fq6_sub(u, self.fq6_mul_by_v(t)), self.fq6_add(t, t))

    def fq4_sq_parts(self, x, y):
        tmp = self.fq2_mul(x, y)
        u = self.fq2_add(x, y)
        v = self.fq2_add(x, self.fq2_mul_xi(y))
        s = self.fq2_sub(self.fq2_mul(u, v), tmp)
        even = self.fq2_sub(s, self.fq2_mul_xi(tmp))
        return even, self.fq2_double(tmp)

    def three_minus_two(self, t, x):
        return self.fq2_add(self.fq2_double(self.fq2_sub(t, x)), t)

    def three_plus_two(self, t, x):
        return self.fq2_add(self.fq2_double(self.fq2_add(t, x)), t)

    def fq12_cyc_sq(self, a):
        """Granger-Scott: the three Fq4 squares of the pairs (c0.c0,
        c1.c1), (c1.c0, c0.c2), (c0.c1, c1.c2), then 3t - 2r and 3t + 2r
        (valid on the cyclotomic subgroup)."""
        (a00, a01, a02), (a10, a11, a12) = a
        t0, t1 = self.fq4_sq_parts(a00, a11)
        t2, t3 = self.fq4_sq_parts(a10, a02)
        t4, t5 = self.fq4_sq_parts(a01, a12)
        return ((self.three_minus_two(t0, a00), self.three_minus_two(t2, a01),
                 self.three_minus_two(t4, a02)),
                (self.three_plus_two(self.fq2_mul_xi(t5), a10),
                 self.three_plus_two(t1, a11), self.three_plus_two(t3, a12)))

    def fq6_mul_by_01(self, g, s0, s1):
        """g * (s0 + s1 v) (pairing/miller.py:_fq6_mul_by_01): its five
        Fq2 products in its order, xi on g2 s1."""
        m, add, sub = self.fq2_mul, self.fq2_add, self.fq2_sub
        t00, t11 = m(g[0], s0), m(g[1], s1)
        u = m(add(g[0], g[1]), add(s0, s1))
        g2s0, g2s1 = m(g[2], s0), m(g[2], s1)
        return (add(t00, self.fq2_mul_xi(g2s1)), sub(sub(u, t00), t11),
                add(g2s0, t11))

    def fq12_mul_line(self, f, a, b, c):
        t0 = tuple(self.fq2_mul(x, a) for x in f[0])  # fq6_mul_by_0
        t1 = self.fq6_mul_by_01(f[1], b, c)
        s = self.fq6_mul_by_01(self.fq6_add(f[0], f[1]), self.fq2_add(a, b), c)
        c1 = self.fq6_sub(self.fq6_sub(s, t0), t1)
        return (self.fq6_add(t0, self.fq6_mul_by_v(t1)), c1)

    def dbl_step(self, t, xp, yp):
        x, y, z = t
        m, sq, small = self.fq2_mul, self.fq2_sq, self.fq2_mul_small
        add, sub = self.fq2_add, self.fq2_sub
        xx, yy, xy, yz = sq(x), sq(y), m(x, y), m(y, z)
        x3, yyz, xyz, xxz, yzz = m(xx, x), m(yy, z), m(xy, z), m(xx, z), m(yz, z)
        nine_x3 = add(small(x3, 8), x3)
        ox = self.fq2_double(m(xyz, sub(nine_x3, small(yyz, 8))))
        u = m(nine_x3, sub(small(yyz, 4), small(x3, 3)))
        oy = sub(u, small(sq(yyz), 8))
        oz = small(m(sq(yz), yz), 8)
        la = self.fq2_mul_fp(self.fq2_neg(self.fq2_double(yzz)), yp)
        lb = self.fq2_mul_fp(small(xxz, 3), xp)
        lc = sub(self.fq2_double(yyz), small(x3, 3))
        return (ox, oy, oz), (la, lb, lc)

    def add_step(self, t, qx, qy, xp, yp):
        x, y, z = t
        m, sq, add, sub = self.fq2_mul, self.fq2_sq, self.fq2_add, self.fq2_sub
        theta, lam = sub(y, m(qy, z)), sub(x, m(qx, z))
        cc, dd = sq(theta), sq(lam)
        ee, ff, gg = m(lam, dd), m(z, cc), m(x, dd)
        hh = sub(add(ee, ff), self.fq2_double(gg))
        la = self.fq2_mul_fp(self.fq2_neg(lam), yp)
        lb = self.fq2_mul_fp(theta, xp)
        lc = sub(m(lam, qy), m(theta, qx))
        ox = m(lam, hh)
        oy = sub(m(theta, sub(gg, hh)), m(ee, y))
        return (ox, oy, m(z, ee)), (la, lb, lc)

    def g1_double(self, p):
        """dbl-2009-l (curve/jacobian.py:double)."""
        t = self.t
        x, y, z = p
        a, b = t.mul(x, x), t.mul(y, y)
        c = t.mul(b, b)
        s = t.add(x, b)
        d = t.sub(t.mul(s, s), t.add(a, c))
        d = t.add(d, d)
        e = self.mul_small(a, 3)
        x3 = t.sub(t.mul(e, e), t.add(d, d))
        y3 = t.sub(t.mul(e, t.sub(d, x3)), self.mul_small(c, 8))
        yz = t.mul(y, z)
        return (x3, y3, t.add(yz, yz))

    def g1_add(self, p1, p2):
        """The complete addition (curve/jacobian.py:add): add-2007-bl, the
        doubling of p1 that the plain body computes on every lane, then
        its masked selects in its order, one SEL per coordinate: the
        doubling if h = 0 and r = 0, the identity (one, one, 0) if h = 0
        and r != 0, p2 if p1 is the identity, p1 if p2 is."""
        t = self.t
        (x1, y1, z1), (x2, y2, z2) = p1, p2
        z1z1, z2z2 = t.mul(z1, z1), t.mul(z2, z2)
        u1, u2 = t.mul(x1, z2z2), t.mul(x2, z1z1)
        s1 = t.mul(t.mul(y1, z2), z2z2)
        s2 = t.mul(t.mul(y2, z1), z1z1)
        h = t.sub(u2, u1)
        r = t.sub(s2, s1)
        r = t.add(r, r)
        h2 = t.add(h, h)
        i = t.mul(h2, h2)
        j, v = t.mul(h, i), t.mul(u1, i)
        x3 = t.sub(t.sub(t.mul(r, r), j), t.add(v, v))
        sj = t.mul(s1, j)
        y3 = t.sub(t.mul(r, t.sub(v, x3)), t.add(sj, sj))
        zh = t.mul(t.mul(z1, z2), h)
        added = (x3, y3, t.add(zh, zh))
        doubled = self.g1_double(p1)
        identity = (TAKE_ONE, TAKE_ONE, TAKE_ZERO)
        return tuple(t.select([
            (TAKE, added[c]),
            (IF_ZERO, h), (IF_ZERO, r), (TAKE, doubled[c]),
            (IF_ZERO, h), (IF_NONZERO, r), (identity[c], None),
            (IF_ZERO, z1), (TAKE, p2[c]),
            (IF_ZERO, z2), (TAKE, p1[c])]) for c in range(3))

    def const_line_fold(self, f, ca, cb, cc, xp1, yp1):
        """f * (ca yP1 + cb xP1 w + cc v w): the second pair's line from
        host-precomputed constants."""
        return self.fq12_mul_line(f, self.fq2_mul_fp(ca, yp1),
                                  self.fq2_mul_fp(cb, xp1), cc)


def _flat(tree):
    if isinstance(tree, Node):
        return [tree]
    return [leaf for sub in tree for leaf in _flat(sub)]


def _fq12(it):
    return tuple(tuple((next(it), next(it)) for _ in range(3)) for _ in range(2))


def trace_miller_dbl_body():
    """(f, t, xp, yp) -> (f^2 * tangent line, 2t): 20 -> 18 Els."""
    tr = Trace()
    tw = Tower(tr)
    it = iter([tr.load(i) for i in range(20)])
    f = _fq12(it)
    t = tuple((next(it), next(it)) for _ in range(3))
    xp, yp = next(it), next(it)
    sq = tw.fq12_sq(f)
    t_out, (la, lb, lc) = tw.dbl_step(t, xp, yp)
    f_out = tw.fq12_mul_line(sq, la, lb, lc)
    return tr, _flat(f_out) + _flat(t_out)


def trace_miller_add_body():
    """(f, t, qx, qy, xp, yp) -> (f * chord line, t + q): 24 -> 18 Els."""
    tr = Trace()
    tw = Tower(tr)
    it = iter([tr.load(i) for i in range(24)])
    f = _fq12(it)
    t = tuple((next(it), next(it)) for _ in range(3))
    qx, qy = (next(it), next(it)), (next(it), next(it))
    xp, yp = next(it), next(it)
    t_out, (la, lb, lc) = tw.add_step(t, qx, qy, xp, yp)
    f_out = tw.fq12_mul_line(f, la, lb, lc)
    return tr, _flat(f_out) + _flat(t_out)


def trace_miller_dbl_body2():
    """(f, t, xp0, yp0, ca, cb, cc, xp1, yp1) -> (f^2 * tangent line *
    constant line, 2t): 28 -> 18 Els."""
    tr = Trace()
    tw = Tower(tr)
    it = iter([tr.load(i) for i in range(28)])
    f = _fq12(it)
    t = tuple((next(it), next(it)) for _ in range(3))
    xp0, yp0 = next(it), next(it)
    ca, cb, cc = ((next(it), next(it)) for _ in range(3))
    xp1, yp1 = next(it), next(it)
    sq = tw.fq12_sq(f)
    t_out, (la, lb, lc) = tw.dbl_step(t, xp0, yp0)
    g = tw.fq12_mul_line(sq, la, lb, lc)
    f_out = tw.const_line_fold(g, ca, cb, cc, xp1, yp1)
    return tr, _flat(f_out) + _flat(t_out)


def trace_miller_add_body2():
    """(f, t, qx, qy, xp0, yp0, ca, cb, cc, xp1, yp1) -> (f * chord line *
    constant line, t + q): 32 -> 18 Els."""
    tr = Trace()
    tw = Tower(tr)
    it = iter([tr.load(i) for i in range(32)])
    f = _fq12(it)
    t = tuple((next(it), next(it)) for _ in range(3))
    qx, qy = (next(it), next(it)), (next(it), next(it))
    xp0, yp0 = next(it), next(it)
    ca, cb, cc = ((next(it), next(it)) for _ in range(3))
    xp1, yp1 = next(it), next(it)
    t_out, (la, lb, lc) = tw.add_step(t, qx, qy, xp0, yp0)
    g = tw.fq12_mul_line(f, la, lb, lc)
    f_out = tw.const_line_fold(g, ca, cb, cc, xp1, yp1)
    return tr, _flat(f_out) + _flat(t_out)


def trace_fq12_mul():
    """(a, b) -> a * b: 24 -> 12 Els."""
    tr = Trace()
    tw = Tower(tr)
    it = iter([tr.load(i) for i in range(24)])
    a, b = _fq12(it), _fq12(it)
    return tr, _flat(tw.fq12_mul(a, b))


def trace_expu_step():
    """(acc, m) -> acc^4 * m by two cyclotomic squarings: 24 -> 12 Els."""
    tr = Trace()
    tw = Tower(tr)
    it = iter([tr.load(i) for i in range(24)])
    acc, m = _fq12(it), _fq12(it)
    return tr, _flat(tw.fq12_mul(tw.fq12_cyc_sq(tw.fq12_cyc_sq(acc)), m))


def trace_expu_sq2():
    """acc -> acc^4 by two cyclotomic squarings: 12 -> 12 Els."""
    tr = Trace()
    tw = Tower(tr)
    acc = _fq12(iter([tr.load(i) for i in range(12)]))
    return tr, _flat(tw.fq12_cyc_sq(tw.fq12_cyc_sq(acc)))


def trace_fq12_cyc_sq():
    """a -> a^2 by the cyclotomic formula: 12 -> 12 Els."""
    tr = Trace()
    tw = Tower(tr)
    a = _fq12(iter([tr.load(i) for i in range(12)]))
    return tr, _flat(tw.fq12_cyc_sq(a))


def trace_fq12_mul_line():
    """(f, a, b, c) -> f * (a + b w + c v w), the sparse line fold: 18 -> 12
    Els."""
    tr = Trace()
    tw = Tower(tr)
    it = iter([tr.load(i) for i in range(18)])
    f = _fq12(it)
    a, b, c = ((next(it), next(it)) for _ in range(3))
    return tr, _flat(tw.fq12_mul_line(f, a, b, c))


def trace_fq12_sq():
    """a -> a^2 by the complex squaring over Fq6: 12 -> 12 Els."""
    tr = Trace()
    tw = Tower(tr)
    a = _fq12(iter([tr.load(i) for i in range(12)]))
    return tr, _flat(tw.fq12_sq(a))


def trace_g2_dbl_step():
    """(t, xp, yp) -> (2t, its tangent line (a, b, c)): 8 -> 12 Els."""
    tr = Trace()
    tw = Tower(tr)
    it = iter([tr.load(i) for i in range(8)])
    t = tuple((next(it), next(it)) for _ in range(3))
    xp, yp = next(it), next(it)
    return tr, _flat(tw.dbl_step(t, xp, yp))


def trace_g2_add_step():
    """(t, qx, qy, xp, yp) -> (t + q, its chord line (a, b, c)): 12 -> 12
    Els."""
    tr = Trace()
    tw = Tower(tr)
    it = iter([tr.load(i) for i in range(12)])
    t = tuple((next(it), next(it)) for _ in range(3))
    qx, qy = (next(it), next(it)), (next(it), next(it))
    xp, yp = next(it), next(it)
    return tr, _flat(tw.add_step(t, qx, qy, xp, yp))


def trace_glv_dbl_add():
    """(acc, sel) -> 2 acc + sel, G1 Jacobian points: 6 -> 3 Els."""
    tr = Trace()
    tw = Tower(tr)
    loads = [tr.load(i) for i in range(6)]
    acc, sel = tuple(loads[:3]), tuple(loads[3:])
    return tr, list(tw.g1_add(tw.g1_double(acc), sel))


def trace_g1_add():
    """(p1, p2) -> p1 + p2, G1 Jacobian points: 6 -> 3 Els."""
    tr = Trace()
    tw = Tower(tr)
    loads = [tr.load(i) for i in range(6)]
    return tr, list(tw.g1_add(tuple(loads[:3]), tuple(loads[3:])))


# key -> (tracer, leaf products of the formula per lane, loads excluded,
# whether its products run cios_wide rather than cios)
BODIES = {
    "miller_dbl_body": (trace_miller_dbl_body, 117, False),
    "expu_step": (trace_expu_step, 90, False),
    "miller_dbl_body2": (trace_miller_dbl_body2, 160, False),
    "miller_add_body2": (trace_miller_add_body2, 123, False),
    "fq12_mul": (trace_fq12_mul, 54, False),
    "miller_add_body": (trace_miller_add_body, 80, False),
    "glv_dbl_add": (trace_glv_dbl_add, 30, True),
    "expu_sq2": (trace_expu_sq2, 36, True),
    "fq12_cyc_sq": (trace_fq12_cyc_sq, 18, True),
    "fq12_mul_line": (trace_fq12_mul_line, 39, True),
    "fq12_sq": (trace_fq12_sq, 36, True),
    "g2_dbl_step": (trace_g2_dbl_step, 42, True),
    "g2_add_step": (trace_g2_add_step, 41, True),
    "g1_add": (trace_g1_add, 23, True),
}


# -- levels and slots ----------------------------------------------------------


@dataclasses.dataclass
class Op:
    kind: int
    out: int  # slot, or NONE
    gout: int  # output El, or NONE
    a: int
    b: int
    node: int  # the traced node it computes


@dataclasses.dataclass
class Schedule:
    key: str
    n_in: int
    n_out: int
    slots: int
    ops: list  # Ops, level by level
    steps: list  # chain steps, code << SLOT_BITS | slot
    level_first: list  # ops[level_first[l]:level_first[l + 1]] is level l
    products: int  # MUL ops (LOADs excluded)
    wide_leaf: bool  # its products run cios_wide

    @property
    def levels(self):
        return len(self.level_first) - 1

    @property
    def lane_words(self):
        """32-bit words of one lane's slots, odd so that lanes start on
        different banks."""
        return self.slots * WORDS_PER_FP | 1


def _levels(roots, reads):
    """Level of each root op: as early as its operands allow, but the
    products of one product depth (the most products on a path from the
    inputs) share one level, so that a group runs them in as few rounds as
    it can (from 1 for fq12_mul to 5 for miller_dbl_body2, loads
    excluded). Then each input is loaded in the last product
    level before its first reader (loads are products), and each addition
    chain runs in the level just before its first reader: both keep fewer
    slots live."""
    users = {n.id: [] for n in roots}
    for n in roots:
        for x in reads[n.id]:
            users[x.id].append(n)
    depth = {}
    for n in roots:  # program order: operands first
        d = max((depth[x.id] for x in reads[n.id]), default=0)
        depth[n.id] = d + (n.op == "mul")
    group = {}  # product depth -> its level
    while True:
        level = {}
        for n in roots:
            lv = 1 + max((level[x.id] for x in reads[n.id]), default=-1)
            if n.op == "mul":
                lv = max(lv, group.get(depth[n.id], 0))
            level[n.id] = lv
        new = {}
        for n in roots:
            if n.op == "mul":
                new[depth[n.id]] = max(new.get(depth[n.id], 0), level[n.id])
        if new == group:
            break
        group = new
    product_levels = sorted({0, *(level[n.id] for n in roots
                                  if n.op == "mul")})
    for n in reversed(roots):
        if not users[n.id] or n.op == "mul":
            continue
        first_use = min(level[u.id] for u in users[n.id])
        if n.op == "load":
            level[n.id] = max(lv for lv in product_levels if lv < first_use)
        else:
            level[n.id] = first_use - 1
    return level


def schedule(key: str) -> Schedule:
    """The level schedule of body `key`, with its slots allocated."""
    tracer = BODIES[key][0]
    tr, outs = tracer()
    nodes = tr.nodes
    consumers = {n.id: set() for n in nodes}
    for n in nodes:
        for a in n.operands():
            consumers[a.id].add(n.id)
    out_of = {}
    for i, n in enumerate(outs):
        out_of.setdefault(n.id, []).append(i)
    if any(len(v) > 1 for v in out_of.values()):
        raise ValueError(f"{key}: one value is two outputs")

    def linear(n):
        return n.op in ("add", "sub")

    def inlinable(n):
        return linear(n) and len(consumers[n.id]) == 1 and n.id not in out_of

    # the operand each linear node continues its chain through
    pred = {}
    for n in nodes:
        if not linear(n):
            continue
        a, b = n.args
        if a is b:
            pred[n.id] = a if inlinable(a) else None
        elif a.op == "zero" or inlinable(a):
            pred[n.id] = a
        elif inlinable(b):
            pred[n.id] = b
        else:
            pred[n.id] = None
    inlined = {p.id for p in pred.values() if p is not None and p.op != "zero"}
    roots = [n for n in nodes if n.op in ("load", "mul", "sel")
             or (linear(n) and n.id not in inlined)]

    def chain(n):
        """[(code, operand node or None)] of linear node n."""
        if n.op == "zero":
            return [(ZERO, None)]
        a, b = n.args
        p = pred[n.id]
        if p is None:
            if b.op == "zero":
                raise ValueError(f"{key}: zero as a right operand")
            if a is b:
                return [(SET, a), (DBL, None)]
            return [(SET, a), (ADD if n.op == "add" else SUB, b)]
        head = chain(p)
        if a is b:
            return head + [(DBL, None)]
        if p is a:
            return head + [(ADD if n.op == "add" else SUB, b)]
        return head + [(ADD if n.op == "add" else RSUB, a)]

    reads, chains = {}, {}  # root id -> the roots its op reads; its chain
    for n in roots:
        if n.op == "load":
            reads[n.id] = []
        elif n.op in ("mul", "sel"):
            reads[n.id] = n.operands()
        else:
            chains[n.id] = chain(n)
            reads[n.id] = [x for _, x in chains[n.id] if x is not None]
    level = _levels(roots, reads)
    last_read, readers = {}, {}  # root id -> last level; (id, level) -> ops
    for n in roots:
        for x in reads[n.id]:
            last_read[x.id] = max(last_read.get(x.id, -1), level[n.id])
            readers.setdefault((x.id, level[n.id]), set()).add(n.id)

    n_levels = 1 + max(level.values())
    by_level = [[] for _ in range(n_levels)]
    for n in roots:
        by_level[level[n.id]].append(n)
    slot_of, free, n_slots = {}, [], 0
    frees_after = [[] for _ in range(n_levels)]
    ops, steps, level_first = [], [], [0]
    products = 0
    for lv, members in enumerate(by_level):
        if lv:
            free = sorted(free + frees_after[lv - 1])
        members.sort(key=lambda n: (n.op not in ("load", "mul"), n.id))
        for n in members:
            slot = NONE
            if n.id in last_read:
                # an operand whose only reader in its last level is this op:
                # the op reads it into registers before it writes
                mine = [x for x in reads[n.id] if last_read[x.id] == lv
                        and readers[(x.id, lv)] == {n.id}
                        and slot_of[x.id] in frees_after[lv]]
                if mine:
                    slot = slot_of[mine[0].id]
                    frees_after[lv].remove(slot)
                elif free:
                    slot = free.pop(0)
                else:
                    slot, n_slots = n_slots, n_slots + 1
                slot_of[n.id] = slot
                frees_after[last_read[n.id]].append(slot)
            gout = out_of.get(n.id, [NONE])[0]
            if n.op == "load":
                ops.append(Op(LOAD, slot, gout, n.args[0], 0, n.id))
            elif n.op == "mul":
                products += 1
                x, y = n.args
                ops.append(Op(MUL, slot, gout, slot_of[x.id], slot_of[y.id],
                              n.id))
            else:
                first = len(steps)
                for code, x in n.args if n.op == "sel" else chains[n.id]:
                    steps.append(code << SLOT_BITS
                                 | (0 if x is None else slot_of[x.id]))
                ops.append(Op(SEL if n.op == "sel" else LIN, slot, gout,
                              first, len(steps) - first, n.id))
        level_first.append(len(ops))
    if n_slots >= 1 << SLOT_BITS or len(steps) >= NONE:
        raise ValueError(f"{key}: schedule too large for its encoding")
    n_in = sum(n.op == "load" for n in nodes)
    return Schedule(key, n_in, len(outs), n_slots, ops, steps, level_first,
                    products, BODIES[key][2])


# -- the header --------------------------------------------------------------


def _camel(key):
    return "".join(w.capitalize() for w in key.split("_"))


def _rows(values, per_line=12):
    vals = [f"{v}" for v in values]
    return "\n".join("    " + ", ".join(vals[i:i + per_line]) + ","
                     for i in range(0, len(vals), per_line))


def header_text() -> str:
    parts = [
        "// Generated by bn254_tpu_torch/kernels/coop_schedule.py; do not edit.",
        "// Level schedules of the lane-cooperative kernels (fused.cu): per",
        "// body, its ops (kind << 14 | out slot, output El, a, b;",
        "// slot 0x3FFF: none), the chain steps of its additions and selects",
        "// (code << 13 | slot), the first op of each level and its leaf.",
        "",
        "#pragma once",
        "",
        "namespace bn254 {",
        "",
    ]
    for key in BODIES:
        s = schedule(key)
        name = _camel(key)
        words = []
        for op in s.ops:
            words += [op.kind << 14 | (op.out if op.out != NONE else 0x3FFF),
                      op.gout, op.a, op.b]
        parts += [
            f"// {key}: {s.n_in} -> {s.n_out} Els, "
            f"{s.products} products, {len(s.ops)} ops in {s.levels} "
            f"levels, {s.slots} slots",
            f"BN_TABLE uint16_t kCoopOps{name}[] = {{",
            _rows(words),
            "};",
            f"BN_TABLE uint16_t kCoopSteps{name}[] = {{",
            _rows(s.steps),
            "};",
            f"BN_TABLE uint16_t kCoopLevels{name}[] = {{",
            _rows(s.level_first),
            "};",
            f"struct Coop{name} {{",
            f"  static constexpr int kIn = {s.n_in}, kOut = {s.n_out};",
            f"  static constexpr int kLevels = {s.levels}, "
            f"kLaneWords = {s.lane_words};",
            f"  static constexpr bool kWideLeaf = "
            f"{'true' if s.wide_leaf else 'false'};",
            f"  static BN_COOP const uint16_t* ops() "
            f"{{ return kCoopOps{name}; }}",
            f"  static BN_COOP const uint16_t* steps() "
            f"{{ return kCoopSteps{name}; }}",
            f"  static BN_COOP const uint16_t* levels() "
            f"{{ return kCoopLevels{name}; }}",
            "};",
            "",
        ]
    parts += ["}  // namespace bn254", ""]
    return "\n".join(parts)


if __name__ == "__main__":
    HEADER.write_text(header_text())
    for k in BODIES:
        s = schedule(k)
        per = [s.level_first[i + 1] - s.level_first[i]
               for i in range(s.levels)]
        print(f"{k}: {s.products} products, "
              f"{len(s.ops)} ops in {s.levels} levels {per}, {s.slots} "
              f"slots ({s.lane_words * 4} B a lane), {len(s.steps)} "
              "chain steps")
