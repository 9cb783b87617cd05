"""Quasi-Monte-Carlo sequences: Halton, Faure-scrambled Halton/Hammersley,
Fibonacci lattices.

The port's copy of lucille_tpu/sampling/qmc.py: the capability of
lucille's src/render/qmc.c (Halton qmc.c:41, Faure permutations
qmc.c:182, generalized scrambled Halton/Hammersley qmc.c:380,428,
Fibonacci lattice qmc.c:545) after Keller, "Strictly Deterministic
Sampling Methods in Computer Graphics" (2001) and Faure, "Good
permutations for extreme discrepancy" (1992).  The sequences are
deterministic functions of integer indices, evaluated with NumPy on the
host, the same code as lucille_tpu's; `halton_torch` is lucille_tpu's
`halton_jax`, the digit loop unrolled to a fixed count, on a tensor of
indices on any device.
"""

from __future__ import annotations

import numpy as np

# First 100 primes — the reference precomputes Faure permutations up to
# dimension 100 at startup (src/render/render.c:210).
PRIMES = np.array(
    [
        2, 3, 5, 7, 11, 13, 17, 19, 23, 29,
        31, 37, 41, 43, 47, 53, 59, 61, 67, 71,
        73, 79, 83, 89, 97, 101, 103, 107, 109, 113,
        127, 131, 137, 139, 149, 151, 157, 163, 167, 173,
        179, 181, 191, 193, 197, 199, 211, 223, 227, 229,
        233, 239, 241, 251, 257, 263, 269, 271, 277, 281,
        283, 293, 307, 311, 313, 317, 331, 337, 347, 349,
        353, 359, 367, 373, 379, 383, 389, 397, 401, 409,
        419, 421, 431, 433, 439, 443, 449, 457, 461, 463,
        467, 479, 487, 491, 499, 503, 509, 521, 523, 541,
    ],
    dtype=np.int64,
)


def radical_inverse(i: int, base: int) -> float:
    """Van der Corput radical inverse of `i` in `base` (qmc.c vdC)."""
    h = 0.0
    f = factor = 1.0 / base
    while i > 0:
        digit = i % base
        h += digit * factor
        i //= base
        factor *= f
    return h


def halton(i: int, base: int) -> float:
    """i-th Halton sample in the given base (qmc.c:41 `halton`)."""
    return radical_inverse(i, base)


def faure_permutations(nmax: int) -> list:
    """Faure's good permutations p_2 .. p_nmax.

    Returns a list `p` with p[b] = permutation of {0..b-1} for base b
    (p[0] = p[1] = None).  Construction after Faure 1992:

    - even b: p_b = 2*p_{b/2} concatenated with 2*p_{b/2}+1
    - odd  b: take p_{b-1}, increment entries >= (b-1)/2, insert the value
      (b-1)/2 in the middle position.

    Spot values match the table in the reference's comment block
    (qmc.c:170-179): p4 = (0,2,1,3), p5 = (0,3,2,1,4), p8 = (0,4,2,6,1,5,3,7).
    """
    p: list = [None, None, np.array([0, 1], dtype=np.int64)]
    for b in range(3, nmax + 1):
        if b % 2 == 0:
            half = p[b // 2]
            p.append(np.concatenate([2 * half, 2 * half + 1]))
        else:
            prev = p[b - 1]
            c = (b - 1) // 2
            bumped = prev + (2 * prev >= (b - 1)).astype(np.int64)
            perm = np.concatenate([bumped[:c], np.array([c], dtype=np.int64), bumped[c:]])
            p.append(perm)
    return p


def generalized_radical_inverse(i, base: int, perm: np.ndarray):
    """Scrambled radical inverse with digit permutation (qmc.c generalized_vdC).

    Vectorized over integer array `i` (NumPy, host-side).
    """
    i = np.asarray(i, dtype=np.int64)
    h = np.zeros(i.shape, dtype=np.float64)
    f = 1.0 / base
    factor = np.full(i.shape, f)
    rem = i.copy()
    # bound the digit loop by the max number of digits present
    maxv = int(rem.max(initial=0))
    ndigits = 1
    while base**ndigits <= maxv:
        ndigits += 1
    for _ in range(ndigits):
        digit = rem % base
        h += perm[digit] * factor
        rem //= base
        factor *= f
    return h


def generalized_halton(i, offset: int, dim: int, perms: list):
    """Generalized scrambled Halton (qmc.c:380).

    dim >= 1; uses the dim-th prime (PRIMES[dim]) as the reference does.
    """
    dim = max(dim, 1)
    dim = min(dim, len(PRIMES) - 1)
    base = int(PRIMES[dim])
    return generalized_radical_inverse(np.asarray(i) + offset, base, perms[base])


def generalized_hammersley(i, offset: int, n: int, dim: int, perms: list):
    """Generalized scrambled Hammersley point set (qmc.c:428).

    dim == 1 returns the equidistant coordinate (i+offset)/n; higher
    dimensions use the (dim-1)-th prime with Faure scrambling.  Index wraps
    modulo n when i+offset exceeds n, as in the reference.
    """
    i = np.asarray(i, dtype=np.int64)
    if dim <= 1:
        return (i + offset) / float(n)
    j = i + offset
    j = np.where(j > n, j % n, j)
    base = int(PRIMES[dim - 1])
    return generalized_radical_inverse(j, base, perms[base])


def fibonacci_lattice(k: int) -> np.ndarray:
    """2D Fibonacci lattice with F_k points in [0,1)^2 (qmc.c:545).

    x_i = i / F_k, y_i = frac(i * F_{k-1} / F_k).
    """
    def fib(n):
        a, b = 1, 1
        for _ in range(n - 2):
            a, b = b, a + b
        return b if n >= 2 else 1

    fk, fk1 = fib(k), fib(k - 1)
    i = np.arange(fk, dtype=np.float64)
    return np.stack([i / fk, np.mod(i * fk1 / fk, 1.0)], axis=-1)


def halton_torch(i, base: int, ndigits: int = 16):
    """Vectorized Halton with a fixed digit budget (lucille_tpu's
    halton_jax): `i` an integer tensor; `ndigits` bounds the unrolled
    digit loop (16 digits in base 2 cover indices < 65536; base 3 covers
    < 43M).  Returns f32 of i's shape, summed in f32 in the same order."""
    import torch

    rem = i.to(torch.int32)
    h = torch.zeros(rem.shape, dtype=torch.float32, device=rem.device)
    f = float(np.float32(1.0 / base))
    factor = torch.tensor(f, dtype=torch.float32)
    for _ in range(ndigits):
        digit = torch.remainder(rem, base)
        h = h + digit.to(torch.float32) * float(factor)
        rem = torch.div(rem, base, rounding_mode="floor")
        factor = factor * f
    return h
