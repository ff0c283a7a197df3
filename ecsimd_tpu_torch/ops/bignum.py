"""L1: digit-plane bignum ops on torch tensors (the subset GFp needs).

A batch of D-digit unsigned integers is a tensor of shape ``(D, *batch)``
whose plane ``k`` holds base-2^16 digit ``k`` (little-endian digits) of every
lane — the layout of ``ecsimd_tpu/ops/bignum.py``.

The JAX package computes in int32 and relies on two things torch does not
give: logical right shifts (``lax.shift_right_logical``) and int32
wraparound on 16x16-bit products. Every function here therefore takes and
returns **int64** planes with digits in [0, 2^16): products, carries and
borrows stay far inside int64, and right shifts only ever see values whose
arithmetic and logical shifts agree (nonnegative ones), except where a
signed floor is wanted and said so. Masks are int64 0/1 tensors of the batch
shape. Control flow is uniform: carries ripple as whole-lane tensors.
"""

from __future__ import annotations

import torch

from ecsimd_tpu.specs import DIGIT_BITS, DIGIT_MASK

I64 = torch.int64


def normalize_signed(t):
    """Signed redundant digits (D, *batch) -> digits in [0, 2^16) plus a
    signed carry-out. ``>>`` on int64 is an arithmetic (floor) shift, so
    v = (v >> n) * 2^n + (v & (2^n - 1)) holds for negative v too.

    The carry ripples over pairs of digits as 32-bit limbs — half the
    serial steps of a per-digit ripple, each step one whole-batch tensor
    operation — which needs |digit| < 2^46 (every caller is far below)."""
    d = t.shape[0]
    if d % 2:
        limbs, bits = t, DIGIT_BITS
    else:
        limbs, bits = t[0::2] + (t[1::2] << DIGIT_BITS), 2 * DIGIT_BITS
    mask = (1 << bits) - 1
    outs = []
    carry = None
    for row in limbs.unbind(0):
        v = row if carry is None else row + carry
        outs.append(v & mask)
        carry = v >> bits
    out = torch.stack(outs)
    if d % 2 == 0:
        out = torch.stack([out & DIGIT_MASK, out >> DIGIT_BITS], dim=1).reshape(t.shape)
    return out, carry


def add(a, b):
    """Digit-wise add with full carry ripple: ``(sum mod 2^(16D), carry)``."""
    return normalize_signed(a + b)


def sub(a, b):
    """Digit-wise subtract with full borrow ripple: ``(diff mod 2^(16D),
    borrow)``. The borrow doubles as the unsigned compare a < b."""
    d, carry = normalize_signed(a - b)
    return d, -carry  # the carry-out of a - b is 0 or -1


def is_zero(a):
    return (a == 0).all(dim=0).to(I64)


def select(mask, a, b):
    """Per-lane masked select: mask ? a : b."""
    return torch.where(mask.to(torch.bool).unsqueeze(0), a, b)


def swap_if(mask, a, b):
    """Per-lane masked swap, returned functionally."""
    m = mask.to(torch.bool).unsqueeze(0)
    return torch.where(m, b, a), torch.where(m, a, b)


def shift_left_one(a):
    """Bit shift left by one with cross-digit carry: ``(shifted, carry)``."""
    top = a >> (DIGIT_BITS - 1)
    out = (a << 1) & DIGIT_MASK
    out[1:] |= top[:-1]
    return out, top[-1]

