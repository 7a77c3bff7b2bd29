"""Log-space probability scalars and vector helpers.

Host-side counterpart of the reference's ``Prob`` newtype
(ref: src/prob.rs:13,181-203): probabilities are stored as natural-log values;
"addition" is logaddexp, "multiplication" is addition of logs.  On the host we
work directly with plain ``float`` / numpy ``float64`` log-values rather than a
wrapper class -- every function here takes and returns *log*-probabilities.

Device kernels (dbgphmm_tpu.ops) use the same semantics via jnp; this module is
the host/NumPy reference implementation used for parity oracles.
"""

from __future__ import annotations

import math

import numpy as np

NEG_INF = float("-inf")
LN2 = math.log(2.0)

# -- scalar ops ---------------------------------------------------------------


def from_prob(p: float) -> float:
    """linear probability -> log probability."""
    if p < 0:
        raise ValueError(f"probability must be >= 0, got {p}")
    return math.log(p) if p > 0 else NEG_INF


def to_prob(lp: float) -> float:
    """log probability -> linear probability."""
    return math.exp(lp)


def is_zero(lp: float) -> bool:
    return lp == NEG_INF


def ladd(x: float, y: float) -> float:
    """logaddexp with the reference's exact branch structure
    (ref: src/prob.rs:181-203): max + log1p(exp(min-max)), with shortcuts for
    zero terms and equal terms, so host scores match the Rust bit-for-bit."""
    if x < y:
        x, y = y, x
    if y == NEG_INF:
        return x
    if x == y:
        return x + LN2
    return x + math.log1p(math.exp(y - x))


def lsum(values) -> float:
    """Sequential left-fold logaddexp (matches Prob::sum iteration order)."""
    acc = NEG_INF
    for v in values:
        acc = ladd(acc, v)
    return acc


def ldiff(x: float, y: float) -> float:
    """log(exp(x) - exp(y)) for x >= y (ref: src/prob.rs log_diff usage)."""
    if x < y:
        x, y = y, x
    if y == NEG_INF:
        return x
    if x == y:
        return NEG_INF
    return x + math.log1p(-math.exp(y - x))


def log_diff_abs(x: float, y: float) -> float:
    """|log px - log py| with inf when exactly one is zero (ref Prob::log_diff)."""
    if is_zero(x) and is_zero(y):
        return 0.0
    if is_zero(x) or is_zero(y):
        return float("inf")
    return abs(x - y)


def diff_abs(x: float, y: float) -> float:
    """|px - py| in linear space."""
    return abs(math.exp(x) - math.exp(y))


# -- cached integer logs (ref: src/prob.rs:30-49, src/utils.rs:105) -----------

_MAX_CACHED = 1024
_LN_TABLE = np.concatenate([[NEG_INF], np.log(np.arange(1, _MAX_CACHED))])
# cumulative log-factorial table: _LOG_FACT[n] = log(n!)
_LOG_FACT = np.concatenate([[0.0], np.cumsum(np.log(np.arange(1, _MAX_CACHED)))])


def ln_int(x: int) -> float:
    """ln(x) for non-negative ints, cached for small values."""
    if x < _MAX_CACHED:
        return float(_LN_TABLE[x])
    return math.log(x)


def log_factorial(n: int) -> float:
    """log(n!) (ref: src/utils.rs:105). Uses lgamma beyond the cache."""
    if n < 0:
        raise ValueError("n must be >= 0")
    if n < _MAX_CACHED:
        return float(_LOG_FACT[n])
    return math.lgamma(n + 1)


# -- vector ops (numpy, for host-side oracles) --------------------------------


def vlsum(a: np.ndarray, axis=None) -> np.ndarray:
    """logsumexp over an axis; empty/all -inf reductions give -inf (not nan)."""
    a = np.asarray(a, dtype=np.float64)
    if a.size == 0:
        shape = np.sum(a, axis=axis).shape
        return np.full(shape, NEG_INF)
    with np.errstate(invalid="ignore"):
        return np.logaddexp.reduce(a, axis=axis)


def normal_logpdf(x: float, mu: float, sigma: float) -> float:
    """log N(x; mu, sigma) (ref: src/distribution.rs:13-29 'normal')."""
    z = (x - mu) / sigma
    return -0.5 * z * z - math.log(sigma) - 0.5 * math.log(2.0 * math.pi)


def normal_bin_logp(x: int, mu: float, sigma: float) -> float:
    """Probability that a Normal(mu, sigma) falls in the unit bin centered at
    integer x, approximated by pdf(x)*1 as the reference does
    (ref: src/distribution.rs:22 'normal')."""
    return normal_logpdf(float(x), mu, sigma)


def kmer_coverage(k: int, read_length: float, coverage: float, p_error: float) -> float:
    """Expected k-mer coverage given base coverage:
    ``c * (L - k + 1) / L * (1 - p)^k`` (ref: src/distribution.rs:31-45)."""
    if read_length <= 0:
        return 0.0
    frac = max(read_length - k + 1, 0.0) / read_length
    return coverage * frac * (1.0 - p_error) ** k
