"""alt_bn128 (BN254) curve operations and the optimal-ate pairing check.

Backs the 0x06/0x07/0x08 precompiles (EIP-196/197; reference
core/vm/contracts.go:81-103 dispatches to cloudflare/google bn256).
Implemented from the EIP specification with a small polynomial
field-extension tower: Fp2 = Fp[i]/(i^2+1), Fp12 = Fp[w]/(w^12 - 18w^6 + 82)
(the standard py_ecc-style modulus embedding of w^6 = 9 + i).

Performance note: the pairing is a correctness implementation (a few
hundred ms per pairing in CPython); pairing-heavy workloads route through
a native path in a later milestone.  bn256 traffic on the C-Chain is rare.
"""

from __future__ import annotations

FIELD_MODULUS = 21888242871839275222246405745257275088696311157297823662689037894645226208583
CURVE_ORDER = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# curve: y^2 = x^3 + 3; G2 twist: y^2 = x^3 + 3/(9+i)
B = 3

# ate loop count for BN254
ATE_LOOP_COUNT = 29793968203157093288
LOG_ATE = 63  # bit length - 1

P = FIELD_MODULUS


def _inv(a: int, n: int) -> int:
    return pow(a, n - 2, n)


# --- polynomial extension fields (coefficients are ints mod P) -------------

class FQP:
    """Element of Fp[x]/modulus_poly; coeffs low-degree-first."""

    degree = 0
    mod_coeffs: tuple = ()

    def __init__(self, coeffs):
        self.coeffs = [c % P for c in coeffs]

    @classmethod
    def one(cls):
        return cls([1] + [0] * (cls.degree - 1))

    @classmethod
    def zero(cls):
        return cls([0] * cls.degree)

    def __add__(self, other):
        return type(self)([a + b for a, b in zip(self.coeffs, other.coeffs)])

    def __sub__(self, other):
        return type(self)([a - b for a, b in zip(self.coeffs, other.coeffs)])

    def __neg__(self):
        return type(self)([-a for a in self.coeffs])

    def __eq__(self, other):
        return self.coeffs == other.coeffs

    def scalar_mul(self, k: int):
        return type(self)([a * k for a in self.coeffs])

    def __mul__(self, other):
        if isinstance(other, int):
            return self.scalar_mul(other)
        d = self.degree
        tmp = [0] * (2 * d - 1)
        for i, a in enumerate(self.coeffs):
            if a:
                for j, b in enumerate(other.coeffs):
                    tmp[i + j] += a * b
        # reduce by modulus poly x^d = -(mod_coeffs)
        for i in range(2 * d - 2, d - 1, -1):
            c = tmp[i]
            if c:
                for j, m in enumerate(self.mod_coeffs):
                    tmp[i - d + j] -= c * m
        return type(self)(tmp[:d])

    def inv(self):
        # extended euclid over Fp[x]
        d = self.degree
        lm, hm = [1] + [0] * d, [0] * (d + 1)
        low = self.coeffs + [0]
        high = list(self.mod_coeffs) + [1]
        while _deg(low):
            r = _poly_div(high, low)
            r += [0] * (d + 1 - len(r))
            nm, new = list(hm), list(high)
            for i in range(d + 1):
                for j in range(d + 1 - i):
                    nm[i + j] -= lm[i] * r[j]
                    new[i + j] -= low[i] * r[j]
            nm = [x % P for x in nm]
            new = [x % P for x in new]
            lm, low, hm, high = nm, new, lm, low
        return type(self)(lm[:d]).scalar_mul(_inv(low[0], P))

    def __truediv__(self, other):
        return self * other.inv()

    def __pow__(self, n: int):
        result = type(self).one()
        base = self
        while n:
            if n & 1:
                result = result * base
            base = base * base
            n >>= 1
        return result

    def is_zero(self):
        return all(c == 0 for c in self.coeffs)


def _deg(p):
    d = len(p) - 1
    while d and p[d] == 0:
        d -= 1
    return d


def _poly_div(a, b):
    """Leading-term polynomial pseudo-division over Fp."""
    dega, degb = _deg(a), _deg(b)
    temp = list(a)
    out = [0] * len(a)
    for i in range(dega - degb, -1, -1):
        q = temp[degb + i] * _inv(b[degb], P)
        out[i] += q
        for j in range(degb + 1):
            temp[i + j] -= q * b[j]
        temp = [x % P for x in temp]
    return [x % P for x in out[:_deg(out) + 1]]


class FQ2(FQP):
    degree = 2
    mod_coeffs = (1, 0)  # i^2 = -1


class FQ12(FQP):
    degree = 12
    mod_coeffs = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)  # w^12 - 18w^6 + 82


FQ2_ONE = FQ2([1, 0])
FQ2_B = FQ2([3, 0]) / FQ2([9, 1])  # twist curve b

G2_GEN = (
    FQ2([10857046999023057135944570762232829481370756359578518086990519993285655852781,
         11559732032986387107991004021392285783925812861821192530917403151452391805634]),
    FQ2([8495653923123431417604973247489272438418190587263600148770280649306958101930,
         4082367875863433681332203403145435568316851327593401208105741076214120093531]),
)


# --- generic curve ops (affine, None = infinity) ---------------------------

def is_on_curve_g1(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B) % P == 0


def is_on_curve_g2(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - FQ2_B).is_zero()


def _add(p1, p2, zero_check, field_div):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return _double(p1, field_div)
        return None
    m = field_div(y2 - y1, x2 - x1)
    x3 = m * m - x1 - x2
    y3 = m * (x1 - x3) - y1
    return (x3, y3)


def _double(pt, field_div):
    if pt is None:
        return None
    x, y = pt
    m = field_div(x * x * 3, y * 2)
    x3 = m * m - x - x
    y3 = m * (x - x3) - y
    return (x3, y3)


def _int_div(a, b):
    return (a % P) * _inv(b % P, P) % P


def _fq_div(a, b):
    return a / b


def g1_add(p1, p2):
    def div(a, b):
        return _int_div(a, b)
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and (y1 + y2) % P == 0:
        return None
    if x1 == x2 and y1 == y2:
        m = div(3 * x1 * x1, 2 * y1)
    elif x1 == x2:
        return None
    else:
        m = div(y2 - y1, x2 - x1)
    x3 = (m * m - x1 - x2) % P
    y3 = (m * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_mul(pt, n: int):
    result = None
    addend = pt
    while n:
        if n & 1:
            result = g1_add(result, addend)
        addend = g1_add(addend, addend)
        n >>= 1
    return result


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and (y1 + y2).is_zero():
        return None
    if x1 == x2 and y1 == y2:
        m = (x1 * x1 * 3) / (y1 * 2)
    elif x1 == x2:
        return None
    else:
        m = (y2 - y1) / (x2 - x1)
    x3 = m * m - x1 - x2
    y3 = m * (x1 - x3) - y1
    return (x3, y3)


def g2_mul(pt, n: int):
    result = None
    addend = pt
    while n:
        if n & 1:
            result = g2_add(result, addend)
        addend = g2_add(addend, addend)
        n >>= 1
    return result


def g2_in_subgroup(pt) -> bool:
    return g2_mul(pt, CURVE_ORDER) is None


# --- pairing ----------------------------------------------------------------

# embed Fp and Fp2 into Fp12: x -> x * w^2 trick from py_ecc: twist maps
# G2 (x, y) over Fp2 to (x' , y') over Fp12 with x' = x * w^2, y' = y * w^3
# after untwisting coefficients via i -> (w^6 - 9).

def _fq2_to_fq12_coeff(el: FQ2):
    """Map a + b*i with i = w^6 - 9 into Fp12 coefficients."""
    a, b = el.coeffs
    out = [0] * 12
    out[0] = a - 9 * b
    out[6] = b
    return FQ12(out)


W = FQ12([0, 1] + [0] * 10)
W2 = W * W
W3 = W2 * W


def twist(pt):
    if pt is None:
        return None
    x, y = pt
    return (_fq2_to_fq12_coeff(x) * W2, _fq2_to_fq12_coeff(y) * W3)


def cast_g1_fq12(pt):
    if pt is None:
        return None
    x, y = pt
    return (FQ12([x] + [0] * 11), FQ12([y] + [0] * 11))


def linefunc(p1, p2, t):
    """Evaluate the line through p1,p2 at t (all in Fp12 affine)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if not (x1 - x2).is_zero():
        m = (y2 - y1) / (x2 - x1)
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = (x1 * x1) * 3 / (y1 * 2)
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def _fq12_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and (y1 + y2).is_zero():
        return None
    if x1 == x2 and y1 == y2:
        m = (x1 * x1) * 3 / (y1 * 2)
    elif x1 == x2:
        return None
    else:
        m = (y2 - y1) / (x2 - x1)
    x3 = m * m - x1 - x2
    y3 = m * (x1 - x3) - y1
    return (x3, y3)


def miller_loop(q, p):
    """Miller loop over the pseudo-binary expansion (py_ecc structure)."""
    if q is None or p is None:
        return FQ12.one()
    r = q
    f = FQ12.one()
    for i in range(LOG_ATE, -1, -1):
        f = f * f * linefunc(r, r, p)
        r = _fq12_add(r, r)
        if ATE_LOOP_COUNT & (2 ** i):
            f = f * linefunc(r, q, p)
            r = _fq12_add(r, q)
    q1 = (q[0] ** P, q[1] ** P)
    nq2 = (q1[0] ** P, -(q1[1] ** P))
    f = f * linefunc(r, q1, p)
    r = _fq12_add(r, q1)
    f = f * linefunc(r, nq2, p)
    return f  # final exponentiation applied once by the caller


def pairing_check(pairs) -> bool:
    """prod e(g1_i, g2_i) == 1 over (g1, g2) affine pairs.

    Millers are accumulated and the (expensive) final exponentiation runs
    once: prod f_i ^ ((p^12-1)/n) == 1  <=>  prod e_i == 1.
    """
    acc = FQ12.one()
    for g1, g2 in pairs:
        if g1 is None or g2 is None:
            continue
        acc = acc * miller_loop(twist(g2), cast_g1_fq12(g1))
    return acc ** ((P ** 12 - 1) // CURVE_ORDER) == FQ12.one()
