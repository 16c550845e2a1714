"""Plain Python-integer elliptic-curve arithmetic (a = 0 curves), G1 over Fq
and G2 over Fq2 = Fq[u]/(u^2 + 1).

Jacobian points are tuples (X, Y, Z), Z = 0 for the identity; affine points
(x, y), None for the identity.  ``FixedBase`` multiplies one point by many
scalars with a table of its windowed multiples; ``multiples`` lists d G for
d = 0 .. count - 1.
"""

from __future__ import annotations

from .params import Curve


class Fq:
    def __init__(self, q: int):
        self.q = q
        self.zero, self.one = 0, 1

    def add(self, a, b):
        return (a + b) % self.q

    def sub(self, a, b):
        return (a - b) % self.q

    def mul(self, a, b):
        return a * b % self.q

    def small(self, a, k: int):
        return a * k % self.q

    def inv(self, a):
        return pow(a, -1, self.q)

    def is_zero(self, a):
        return a == 0


class Fq2:
    def __init__(self, q: int):
        self.q = q
        self.zero, self.one = (0, 0), (1, 0)

    def add(self, a, b):
        return ((a[0] + b[0]) % self.q, (a[1] + b[1]) % self.q)

    def sub(self, a, b):
        return ((a[0] - b[0]) % self.q, (a[1] - b[1]) % self.q)

    def mul(self, a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % self.q, (a[0] * b[1] + a[1] * b[0]) % self.q)

    def small(self, a, k: int):
        return (a[0] * k % self.q, a[1] * k % self.q)

    def inv(self, a):
        t = pow(a[0] * a[0] + a[1] * a[1], -1, self.q)
        return (a[0] * t % self.q, -a[1] * t % self.q)

    def is_zero(self, a):
        return a == (0, 0)


class Group:
    """Point arithmetic of one curve's group over its coordinate field."""

    def __init__(self, curve: Curve):
        self.curve = curve
        self.F = Fq(curve.q) if curve.ext == 1 else Fq2(curve.q)
        self.identity = (self.F.one, self.F.one, self.F.zero)

    def is_identity(self, P) -> bool:
        return self.F.is_zero(P[2])

    def double(self, P):
        F = self.F
        X, Y, Z = P
        if F.is_zero(Z):
            return P
        A, B = F.mul(X, X), F.mul(Y, Y)
        C = F.mul(B, B)
        t = F.add(X, B)
        D = F.small(F.sub(F.sub(F.mul(t, t), A), C), 2)
        E = F.small(A, 3)
        X3 = F.sub(F.mul(E, E), F.small(D, 2))
        Y3 = F.sub(F.mul(E, F.sub(D, X3)), F.small(C, 8))
        return (X3, Y3, F.small(F.mul(Y, Z), 2))

    def add_affine(self, P, A):
        """P (Jacobian) + A (affine, None = identity)."""
        F = self.F
        if A is None:
            return P
        if F.is_zero(P[2]):
            return (A[0], A[1], F.one)
        X1, Y1, Z1 = P
        z1z1 = F.mul(Z1, Z1)
        H = F.sub(F.mul(A[0], z1z1), X1)
        r = F.sub(F.mul(A[1], F.mul(Z1, z1z1)), Y1)
        if F.is_zero(H):
            return self.double(P) if F.is_zero(r) else self.identity
        HH = F.mul(H, H)
        HHH = F.mul(H, HH)
        V = F.mul(X1, HH)
        X3 = F.sub(F.sub(F.mul(r, r), HHH), F.small(V, 2))
        Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.mul(Y1, HHH))
        return (X3, Y3, F.mul(Z1, H))

    def to_affine_many(self, Ps) -> list:
        """Jacobian points -> affine (None for the identity), one inversion."""
        F = self.F
        zs = [P[2] for P in Ps if not F.is_zero(P[2])]
        prefix, acc = [], F.one
        for z in zs:
            prefix.append(acc)
            acc = F.mul(acc, z)
        inv = F.inv(acc) if zs else F.one
        zinv = [None] * len(zs)
        for i in range(len(zs) - 1, -1, -1):
            zinv[i] = F.mul(inv, prefix[i])
            inv = F.mul(inv, zs[i])
        out, k = [], 0
        for P in Ps:
            if F.is_zero(P[2]):
                out.append(None)
                continue
            zi = zinv[k]
            k += 1
            zi2 = F.mul(zi, zi)
            out.append((F.mul(P[0], zi2), F.mul(P[1], F.mul(zi, zi2))))
        return out

    def scalar_mul(self, A, k: int):
        """k A (A affine), double-and-add from the top bit; Jacobian."""
        P = self.identity
        for bit in bin(k % self.curve.r)[2:]:
            P = self.double(P)
            if bit == "1":
                P = self.add_affine(P, A)
        return P

    def multiples(self, A, count: int) -> list:
        """[d A for d in range(count)], affine."""
        P, out = self.identity, []
        for _ in range(count):
            out.append(P)
            P = self.add_affine(P, A)
        return self.to_affine_many(out)

    def matches(self, P, A) -> bool:
        """Jacobian P (plain coordinates) equals affine A (None = identity)."""
        F = self.F
        if A is None or F.is_zero(P[2]):
            return A is None and F.is_zero(P[2])
        zz = F.mul(P[2], P[2])
        return P[0] == F.mul(A[0], zz) and P[1] == F.mul(A[1], F.mul(P[2], zz))


class FixedBase:
    """k A for many scalars k by windows of ``bits`` bits: a table of
    d 2^(bits w) A per window w, then one mixed add per nonzero window."""

    def __init__(self, group: Group, A, bits: int = 8):
        self.g, self.bits = group, bits
        r_bits = group.curve.r.bit_length()
        self.windows = -(-r_bits // bits)
        base, rows = A, []
        for _ in range(self.windows):
            rows.append(group.multiples(base, 1 << bits))
            P = (base[0], base[1], group.F.one)
            for _ in range(bits):
                P = group.double(P)
            base = group.to_affine_many([P])[0]
        self.table = rows

    def mul(self, k: int):
        g, mask = self.g, (1 << self.bits) - 1
        P = g.identity
        k %= g.curve.r
        for w in range(self.windows):
            d = (k >> (self.bits * w)) & mask
            if d:
                P = g.add_affine(P, self.table[w][d])
        return P

    def mul_many(self, ks) -> list:
        """Affine k A for every k (None for the identity)."""
        return self.g.to_affine_many([self.mul(k) for k in ks])
