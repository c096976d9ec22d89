"""Number-theory utilities (host-side, Python ints).

A copy of sgfhe_tpu/utils/primes.py, kept in this package so that the port
imports nothing of the JAX package. Re-implementation of the reference's
modulus search
(reference: src/utils.jl:7-28 `find_modulus`), extended with an RNS prime-chain
search that the reference does not need (it uses a single big prime Q via
DarkIntegers wide ints; we represent Q as a product of <2^30 NTT-friendly
primes so every device-side op stays in uint32 lanes).

Everything in this file runs at `Params` construction time on the host; nothing
here runs on a device.
"""

from __future__ import annotations


_SMALL_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin, exact for all n < 3.3e24 (covers our use)."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    # Deterministic witness set for n < 3,317,044,064,679,887,385,961,981.
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def find_modulus(n: int, qmin: int, qmax: int | None = None) -> int:
    """Smallest prime q with qmin <= q (<= qmax), q ≡ 1 (mod n).

    Mirrors reference src/utils.jl:7-28: such q makes the ring Z_q admit an
    NTT of length n/2 over x^(n/2)+1 (negacyclic) because q-1 is a multiple
    of n.
    """
    j = -(-(qmin - 1) // n)  # cld(qmin-1, n)
    while True:
        q = j * n + 1
        if qmax is not None and q > qmax:
            raise ValueError(f"could not find a modulus between {qmin} and {qmax}")
        if is_prime(q):
            return q
        j += 1


def prev_modulus(n: int, qstart: int) -> int:
    """Largest prime q <= qstart with q ≡ 1 (mod n)."""
    j = (qstart - 1) // n
    while j > 0:
        q = j * n + 1
        if is_prime(q):
            return q
        j -= 1
    raise ValueError("no prime found below start")


def inv_mod(a: int, m: int) -> int:
    return pow(a % m, -1, m)


def _int_nthroot(x: int, k: int) -> int:
    """floor(x ** (1/k)) exactly for big ints."""
    if x < 0:
        raise ValueError
    r = int(round(x ** (1.0 / k)))
    while r ** k > x:
        r -= 1
    while (r + 1) ** k <= x:
        r += 1
    return r


def find_rns_primes(
    stride: int, qmin: int, qmax: int, count: int, limit: int = 1 << 29
) -> tuple[int, ...]:
    """Find `count` distinct primes p_i ≡ 1 (mod stride), each < `limit`,
    with qmin <= prod(p_i) <= qmax.

    This replaces the reference's single prime Q = find_modulus(2m, Qmin, Qmax)
    (src/fhe.jl:64-69): our Q is a product of NTT-friendly uint32 primes so all
    mod-Q arithmetic on the device is componentwise RNS over 32-bit lanes.

    Strategy: fix the first count-1 primes near the balanced size, then search
    the induced window for the last one; on failure walk the (count-1)-th prime
    downward and retry.
    """
    if count == 1:
        return (find_modulus(stride, qmin, qmax),)

    base = _int_nthroot(qmax, count)
    if base >= limit:
        raise ValueError(
            f"balanced prime size {base} exceeds limit {limit}; increase count"
        )

    # First count-1 primes: descending chain starting just below `base`.
    head: list[int] = []
    p = base
    for _ in range(count - 1):
        p = prev_modulus(stride, p - 1 if head else p)
        head.append(p)

    for _ in range(4096):  # retry budget
        prod_head = 1
        for h in head:
            prod_head *= h
        lo = -(-qmin // prod_head)
        hi = qmax // prod_head
        # scan the window for the tail prime ≡ 1 (mod stride), distinct from head
        j = -(-(lo - 1) // stride)
        while True:
            q = j * stride + 1
            if q > hi:
                break
            if q < limit and q not in head and is_prime(q):
                primes = tuple(sorted(head + [q], reverse=True))
                prod = 1
                for pp in primes:
                    prod *= pp
                assert qmin <= prod <= qmax
                assert all(pp < limit for pp in primes)
                return primes
            j += 1
        # no tail prime in window: nudge the smallest head prime down and retry
        head[-1] = prev_modulus(stride, head[-1] - 1)
    raise ValueError(
        f"could not find {count} RNS primes ≡1 mod {stride} with product in "
        f"[{qmin}, {qmax}]"
    )


def primitive_root(p: int) -> int:
    """Smallest primitive root modulo prime p."""
    factors = []
    phi = p - 1
    d = phi
    f = 2
    while f * f <= d:
        if d % f == 0:
            factors.append(f)
            while d % f == 0:
                d //= f
        f += 1
    if d > 1:
        factors.append(d)
    g = 2
    while True:
        if all(pow(g, phi // f, p) != 1 for f in factors):
            return g
        g += 1


def root_of_unity(order: int, p: int) -> int:
    """An element of exact multiplicative order `order` mod prime p."""
    if (p - 1) % order != 0:
        raise ValueError(f"{order} does not divide {p}-1")
    g = primitive_root(p)
    w = pow(g, (p - 1) // order, p)
    # exact order check: w^(order/f) != 1 for prime factors f of order
    o = order
    f = 2
    while f * f <= o:
        if o % f == 0:
            assert pow(w, order // f, p) != 1
            while o % f == 0:
                o //= f
        f += 1
    if o > 1:
        assert pow(w, order // o, p) != 1
    return w


def close_primes(moduli) -> bool:
    """True when every pair of moduli is within 2x of each other
    (max < 2*min) — the ONE shared predicate behind the flatten fast path:
    a value canonical mod p_j is then < 2*p_i for every i, so cross-limb
    re-embeddings need a single conditional subtract instead of a Barrett
    reduction (ops/rns.flatten, ops/fused._flatten_k). Holds for every
    Params-derived prime set (one narrow search window, find_rns_primes)."""
    moduli = tuple(moduli)
    return bool(moduli) and max(moduli) < 2 * min(moduli)
