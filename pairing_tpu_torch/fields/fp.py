"""Batched BN254 base-field (Fq) arithmetic over int32 limb tensors.

PyTorch counterpart of ``pairing_tpu/fields/fp.py`` with the same
representation, so values and bounds carry across limb for limb:

  * an element batch is an int32 tensor ``[..., NLIMBS]`` — radix ``2^13``,
    21 limbs (273 bits);
  * multiplication is SOS Montgomery with ``R = 2^273`` (``R > 4p``, so
    products of values ``< 2p`` come out ``< 2p`` without a conditional
    subtraction);
  * carries are a fixed number of data-parallel shift/mask rounds
    ("quasi-carry"); limbs settle to ``[0, SETTLED = 2^13 + 1]``;
  * value and limb bounds are tracked statically (Python ints on the
    :class:`Fp` / :class:`WideAcc` dataclasses), so reductions are inserted
    exactly where the reference inserts them.

Every function runs eagerly on whatever device its input tensors live on;
constructors take an explicit ``device``. The schoolbook limb product is an
outer product scattered into polynomial positions with ``index_add_``
(int32 matmul is not available on CUDA, and a float32 matmul is not exact).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils.bn254 import P

# ---------------------------------------------------------------------------
# Limb configuration
# ---------------------------------------------------------------------------

RADIX_BITS = 13
RADIX = 1 << RADIX_BITS
MASK = RADIX - 1
NLIMBS = 21
assert NLIMBS * RADIX_BITS >= 254 + 13  # headroom: R > 4p (Walter bound)

#: Montgomery radix R = 2^273.
R_MONT = 1 << (RADIX_BITS * NLIMBS)
assert R_MONT > 4 * P

R2_MOD_P = (R_MONT * R_MONT) % P
R_MOD_P = R_MONT % P
#: N' = -p^{-1} mod R  (so p * N' == -1 mod R).
NPRIME = (-pow(P, -1, R_MONT)) % R_MONT

#: Max value bound accepted by mul without an auto weak-reduction.
MAX_MUL_INPUT = 1 << 258

WIDE_NLIMBS = 2 * NLIMBS + 2  # 44 positions: products + accumulation headroom

#: Limbs <= SETTLED count as carry-settled; all op bounds assume it
#: (21 * SETTLED^2 < 2^31 keeps schoolbook position sums in int32).
SETTLED = RADIX + 1
assert NLIMBS * SETTLED * SETTLED < 2**31

DTYPE = torch.int32


def int_to_limbs(x: int, n: int = NLIMBS) -> np.ndarray:
    assert 0 <= x < (1 << (RADIX_BITS * n)), "value does not fit"
    out = np.zeros((n,), dtype=np.int32)
    for i in range(n):
        out[i] = x & MASK
        x >>= RADIX_BITS
    return out


def limbs_to_int(limbs) -> int:
    arr = np.asarray(limbs, dtype=np.int64)
    return sum(int(v) << (RADIX_BITS * i) for i, v in enumerate(arr))


@lru_cache(maxsize=None)
def _const_limbs(value: int, n: int = NLIMBS) -> np.ndarray:
    return int_to_limbs(value, n)


P_LIMBS = _const_limbs(P)
NPRIME_LIMBS = _const_limbs(NPRIME)


def _const(value_limbs: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Host limb constant as a tensor on ``like``'s device."""
    return torch.as_tensor(value_limbs, dtype=DTYPE, device=like.device)


# ---------------------------------------------------------------------------
# Fp value container (static bounds)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Fp:
    """A batch of Fq elements: ``limbs`` int32 ``[..., NLIMBS]``.

    ``bound``: the represented value is < bound.
    ``limb_bound``: every limb is <= limb_bound.
    Values are redundant (not reduced mod p) until :func:`canonical`.
    """

    limbs: torch.Tensor
    bound: int = 2 * P
    limb_bound: int = RADIX

    @property
    def batch_shape(self):
        return tuple(self.limbs.shape[:-1])

    @property
    def device(self):
        return self.limbs.device


def fp_from_ints(xs: Sequence[int], device) -> Fp:
    """Host int list -> Fp batch of shape [len(xs)] (non-Montgomery)."""
    arr = np.stack([int_to_limbs(int(x) % P) for x in xs])
    return Fp(torch.as_tensor(arr, device=device), bound=P, limb_bound=MASK)


def fp_from_ints_mont(xs: Sequence[int], device) -> Fp:
    """Host int list -> Montgomery-domain Fp batch (x * R mod p, canonical
    digits), entered on the host.

    With the native codec (``pairing_tpu_torch.native``) each value is
    packed to 32 little-endian bytes and enters the Montgomery domain in C;
    without it, in Python. Both give the same canonical digits."""
    from .. import native

    if native.available():
        buf = b"".join((int(x) % P).to_bytes(32, "little") for x in xs)
        packed = np.frombuffer(buf, np.uint8).reshape(len(xs), 32)
        return Fp(torch.as_tensor(native.unpack_mont(packed), device=device),
                  bound=P, limb_bound=MASK)
    return fp_from_ints([(int(x) % P) * R_MONT % P for x in xs], device)


def fp_to_ints(a: Fp) -> np.ndarray:
    """Device -> host python ints (object array over batch)."""
    flat = a.limbs.reshape(-1, NLIMBS).cpu().numpy()
    vals = np.array([limbs_to_int(row) for row in flat], dtype=object)
    return vals.reshape(a.batch_shape or (1,))


# ---------------------------------------------------------------------------
# Carry propagation
# ---------------------------------------------------------------------------


def _carry_round(x: torch.Tensor) -> torch.Tensor:
    """One data-parallel carry round; value-preserving, needs top headroom."""
    lo = x & MASK
    hi = x >> RADIX_BITS  # arithmetic shift: signed-safe
    return lo + torch.nn.functional.pad(hi[..., :-1], (1, 0))


def _rounds_needed(limb_bound: int) -> int:
    rounds = 0
    b = limb_bound
    while b > SETTLED:
        b = MASK + (b >> RADIX_BITS) + 1
        rounds += 1
    return rounds


def quasi_carry(x: torch.Tensor, limb_bound: int, signed: bool = False) -> torch.Tensor:
    """Carry-settle ``x`` so limbs lie in [0, SETTLED]. ``limb_bound`` is the
    static magnitude bound of input positions. Extra rounds are run for
    signed inputs so borrows resolve."""
    rounds = _rounds_needed(limb_bound) + (3 if signed else 0)
    for _ in range(rounds):
        x = _carry_round(x)
    return x


def _ripple_carry(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact sequential carry; returns (canonical digits, carry-out)."""
    carry = torch.zeros_like(x[..., 0])
    digits = []
    for i in range(x.shape[-1]):
        t = x[..., i] + carry
        digits.append(t & MASK)
        carry = t >> RADIX_BITS
    return torch.stack(digits, dim=-1), carry


# ---------------------------------------------------------------------------
# Wide (unreduced) products
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WideAcc:
    """Unreduced product accumulator: int32 ``[..., WIDE_NLIMBS]``.

    ``val_bound``: the represented integer value is < val_bound.
    ``limb_bound``: every limb is <= limb_bound (must stay < 2^31 headroom).
    """

    limbs: torch.Tensor
    val_bound: int
    limb_bound: int


#: Position i + j of each outer-product entry (i, j), row-major.
_CONV_POS = np.add.outer(np.arange(NLIMBS), np.arange(NLIMBS)).reshape(-1)
_CONV_FULL = 2 * NLIMBS - 1  # positions 0..40 of a full 21 x 21 product


def _mul_wide_raw(a: torch.Tensor, b: torch.Tensor, ncols: int) -> torch.Tensor:
    """Schoolbook limb product, positions 0..ncols-1.

    The 441 limb products are scattered into their positions with one
    ``index_add_``; positions >= ncols are dropped (the mod-R truncation
    ``mont_reduce`` wants). Batch shapes broadcast.
    """
    bs = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    outer = (a.unsqueeze(-1) * b.unsqueeze(-2)).reshape(bs + (NLIMBS * NLIMBS,))
    pos = torch.as_tensor(_CONV_POS, device=a.device)
    acc = torch.zeros(bs + (max(ncols, _CONV_FULL),), dtype=DTYPE, device=a.device)
    acc.index_add_(-1, pos, outer)
    return acc[..., :ncols]


def mul_wide(a: Fp, b: Fp) -> WideAcc:
    """a*b as a carried wide accumulator (no reduction)."""
    a, b = _prepare_mul_operand(a), _prepare_mul_operand(b)
    return _mul_wide_noprep(a, b)


def wide_add(x: WideAcc, y: WideAcc) -> WideAcc:
    lb = x.limb_bound + y.limb_bound
    assert lb < 2**31
    return WideAcc(x.limbs + y.limbs, x.val_bound + y.val_bound, lb)


def wide_from_fp(a: Fp) -> WideAcc:
    """Embed an Fp into a wide accumulator (e.g. for t + sum(products))."""
    limbs = torch.nn.functional.pad(a.limbs, (0, WIDE_NLIMBS - NLIMBS))
    return WideAcc(limbs, val_bound=a.bound, limb_bound=a.limb_bound)


def mont_reduce(t: WideAcc) -> Fp:
    """Montgomery reduction: value(t) * R^{-1} mod p, output < t/R + ~p.

    SOS shape: m = (t mod R) * N' mod R, out = (t + m*p) / R. The division
    is exact; the low-half carry-out is recovered via the {0, R} dichotomy
    (low part value is a multiple of R bounded by ~R, so it is 0 or R).
    """
    assert t.val_bound <= R_MONT * P * 16, "wide accumulator too large to reduce"
    if t.limb_bound > SETTLED:
        t = WideAcc(quasi_carry(t.limbs, t.limb_bound), t.val_bound, SETTLED)

    lo = t.limbs[..., :NLIMBS]
    m_raw = _mul_wide_raw(lo, _const(NPRIME_LIMBS, lo), NLIMBS + 1)
    m = quasi_carry(m_raw, NLIMBS * SETTLED * MASK)[..., :NLIMBS]

    u_raw = _mul_wide_raw(m, _const(P_LIMBS, m), WIDE_NLIMBS)
    s = quasi_carry(u_raw + t.limbs, NLIMBS * SETTLED * MASK + SETTLED)

    carry_out = (s[..., :NLIMBS] != 0).any(dim=-1).to(DTYPE)
    out = s[..., NLIMBS : 2 * NLIMBS].clone()
    out[..., 0] += carry_out
    # m <= R(1 + 2^-13)  =>  out < t/R + p(1 + 2^-12); track that slack so
    # canonical()'s weak-reduce loop converges below 2p.
    bound = t.val_bound // R_MONT + P + (P >> 10) + 1
    return Fp(out, bound=bound, limb_bound=SETTLED)


def _mul_wide_noprep(a: Fp, b: Fp) -> WideAcc:
    assert a.limb_bound <= SETTLED and b.limb_bound <= SETTLED
    raw = _mul_wide_raw(a.limbs, b.limbs, WIDE_NLIMBS)
    carried = quasi_carry(raw, NLIMBS * a.limb_bound * b.limb_bound)
    return WideAcc(carried, val_bound=a.bound * b.bound, limb_bound=SETTLED)


def _prepare_mul_operand(a: Fp) -> Fp:
    if a.limb_bound > SETTLED:
        a = Fp(quasi_carry(a.limbs, a.limb_bound), a.bound, SETTLED)
    if a.bound > MAX_MUL_INPUT:
        a = weak_reduce(a)
    return a


# ---------------------------------------------------------------------------
# Fp ops
# ---------------------------------------------------------------------------


def fp_add(a: Fp, b: Fp) -> Fp:
    lb = a.limb_bound + b.limb_bound
    assert a.bound + b.bound < R_MONT
    out = Fp(a.limbs + b.limbs, a.bound + b.bound, lb)
    if lb > 2**29:
        out = Fp(quasi_carry(out.limbs, lb), out.bound, SETTLED)
    return out


def _pad1(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 1))


def fp_neg(a: Fp) -> Fp:
    """kp - a for the smallest multiple kp >= bound(a); branchless."""
    k = -(-a.bound // P)  # ceil
    kp_np = _const_limbs(k * P, NLIMBS + 1)
    x = _const(kp_np, a.limbs) - _pad1(a.limbs)
    limb_in = int(kp_np.max()) + a.limb_bound
    limbs = quasi_carry(x, limb_in, signed=True)[..., :NLIMBS]
    return Fp(limbs, bound=k * P + 1, limb_bound=SETTLED)


def fp_sub(a: Fp, b: Fp) -> Fp:
    """a - b + kp for the smallest kp >= bound(b); branchless signed carry."""
    k = -(-b.bound // P)
    kp_np = _const_limbs(k * P, NLIMBS + 1)
    x = _pad1(a.limbs) - _pad1(b.limbs) + _const(kp_np, a.limbs)
    bound = a.bound + k * P
    assert bound < R_MONT, "subtraction bound overflow; weak_reduce operands"
    limb_in = a.limb_bound + b.limb_bound + int(kp_np.max())
    limbs = quasi_carry(x, limb_in, signed=True)
    return Fp(limbs[..., :NLIMBS], bound, SETTLED)


def fp_scale(a: Fp, k: int) -> Fp:
    """Multiply by a small static non-negative int."""
    assert 0 <= k
    lb = a.limb_bound * k
    assert lb < 2**31
    out = Fp(a.limbs * k, a.bound * k, lb)
    if lb > 2**29:
        out = Fp(quasi_carry(out.limbs, lb), out.bound, SETTLED)
    return out


def mont_mul(a: Fp, b: Fp) -> Fp:
    return mont_reduce(mul_wide(a, b))


def fp_const(value: int, batch_shape: Tuple[int, ...], device) -> Fp:
    limbs = torch.as_tensor(_const_limbs(value % P), dtype=DTYPE, device=device)
    return Fp(limbs.expand(tuple(batch_shape) + (NLIMBS,)), bound=P, limb_bound=MASK)


def fp_mont_one(batch_shape: Tuple[int, ...], device) -> Fp:
    """R mod p — the Montgomery-domain representation of 1."""
    return fp_const(R_MOD_P, batch_shape, device)


def fp_const_mont(value: int, batch_shape: Tuple[int, ...], device) -> Fp:
    """Host constant, pre-converted to the Montgomery domain (value * R)."""
    return fp_const((value % P) * R_MONT % P, batch_shape, device)


def to_mont(a: Fp) -> Fp:
    return mont_mul(a, fp_const(R2_MOD_P, (), a.device))


def from_mont(a: Fp) -> Fp:
    return mont_reduce(wide_from_fp(a))


def weak_reduce(a: Fp) -> Fp:
    """Shrink the value bound without leaving the Montgomery domain
    (multiplies by (R mod p) * R^{-1} = 1 mod p)."""
    if a.limb_bound > SETTLED:
        a = Fp(quasi_carry(a.limbs, a.limb_bound), a.bound, SETTLED)
    one = fp_mont_one((), a.device)
    return mont_reduce(_mul_wide_noprep(a, Fp(one.limbs, one.bound, MASK)))


def canonical(a: Fp) -> Fp:
    """Fully reduced representative in [0, p), canonical digits: one launch
    of ``k_canonical`` on CUDA tensors, :func:`canonical_plain` on CPU ones
    (``ops.canon_kernels``)."""
    from ..ops.canon_kernels import canonical as kcanonical

    return kcanonical(a)


def canonical_plain(a: Fp) -> Fp:
    """Plain PyTorch version of :func:`canonical`: weak reductions down to
    2p, then an exact carry and one conditional subtraction of p."""
    while a.bound > 2 * P:
        a = weak_reduce(a)
    digits, _ = _ripple_carry(a.limbs)  # carry-out is zero: bound < 2p < R
    diff, borrow = _ripple_carry(digits - _const(P_LIMBS, digits))
    out = torch.where((borrow >= 0).unsqueeze(-1), diff, digits)
    return Fp(out, bound=P, limb_bound=MASK)


def fp_select(mask: torch.Tensor, a: Fp, b: Fp) -> Fp:
    """Elementwise select over the batch: mask ? a : b. mask: bool [...]."""
    limbs = torch.where(mask.unsqueeze(-1), a.limbs, b.limbs)
    return Fp(limbs, max(a.bound, b.bound), max(a.limb_bound, b.limb_bound))


def fp_eq(a: Fp, b: Fp) -> torch.Tensor:
    """Exact equality mod p (canonicalizes both sides): bool [...]. Two
    representatives of one value below 2p may differ by p. One launch of
    ``k_canonical``'s compare mode on CUDA tensors (``ops.canon_kernels``)."""
    from ..ops.canon_kernels import all_equal

    return all_equal([(a, b)])


def fp_is_zero(a: Fp) -> torch.Tensor:
    from ..ops.canon_kernels import all_equal

    return all_equal([(a, None)])


def _cap_2p(a: Fp) -> Fp:
    """Normalize to the loop-stable envelope: bound <= 2p, settled limbs."""
    if a.bound > 2 * P:
        a = weak_reduce(a)
    if a.limb_bound > SETTLED:
        a = Fp(quasi_carry(a.limbs, a.limb_bound), a.bound, SETTLED)
    assert a.bound <= 2 * P
    return Fp(a.limbs, 2 * P, SETTLED)


def fp_pow_bits(a: Fp, e: int) -> Fp:
    """a^e by MSB-first square-and-multiply; Montgomery domain in/out.

    The exponent is a host int, so each bit's multiply is a static branch
    (the reference's scan multiplies by one on clear bits: same value)."""
    assert e >= 1
    a = _cap_2p(a)
    res = a
    for bit in bin(e)[3:]:  # leading bit consumed by starting at a
        res = _cap_2p(mont_mul(res, res))
        if bit == "1":
            res = _cap_2p(mont_mul(res, a))
    return res


def fp_inv(a: Fp) -> Fp:
    """Fermat inverse a^(p-2); Montgomery domain in/out."""
    return fp_pow_bits(a, P - 2)


def batch_inv(elems: Sequence[Fp]) -> Tuple[Fp, ...]:
    """Montgomery's batch-inversion trick: one fp_inv for N elements."""
    n = len(elems)
    assert n >= 1
    prefix = [elems[0]]
    for i in range(1, n):
        prefix.append(mont_mul(prefix[-1], elems[i]))
    inv_all = fp_inv(prefix[-1])
    out: list = [None] * n
    for i in range(n - 1, 0, -1):
        out[i] = mont_mul(inv_all, prefix[i - 1])
        inv_all = mont_mul(inv_all, elems[i])
    out[0] = inv_all
    return tuple(out)
