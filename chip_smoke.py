"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: build, verify, time.

    python3 chip_smoke.py

Drives ``ecsimd_tpu_torch`` (never JAX, nothing of the JAX package) through
its main paths at bench.py's deployment size, 524,288 lanes, with bench.py's
scalar draw (uniform mod n, edge scalars 1, 2, 5, n-2 first): batched
P-256 scalar multiplication — fixed-base k_i * G through the comb kernel,
variable-base k_i * P_i through the co-Z ladder and through the signed
window, each followed by the affine-conversion kernel — batched ECDH, and
batched ECDSA sign / verify / recover on P-256 and secp256k1 (comb, strict
window, strict GLV and affine kernels), batched X25519 keygen and exchange
(Wei25519 comb, affine, x-only ladder and x / z kernels), the int32
calibration, the comb's other schedules (tree, pipe, multi-chain and
unrolled: kernels J, K, L), the variable-base kernels and the comb's
schedules on secp256k1, Wei25519, P-384 and P-521, and multi-scalar
multiplication (kernel M, the reduction tree), the shared-scalar ladder and
SEC1 encoding on all five. Phases, one line each;
any failed check raises and the script exits non-zero:

  0. device: a CUDA card is required; prints its name, power limit and
     maximum SM clock.
  1. build: compiles every CUDA source of the port with nvcc (sm_90a), one
     process per source, and prints the build seconds, each kernel's
     registers, spills, stack frame and shared memory, each source's nvcc
     seconds, and the SASS of kernels E and F, of B, L, A, D, J and K on
     their five curves, and of G and H, by instruction class (bench/sass.py:
     cuobjdump -sass, each loop's body times its runs; B's, J's, K's and
     L's tensor-core products, IMMA, among them; D's a thread's G lanes
     over G).
  2. field probe (kernel C) against the plain GFp: 65,536 lanes, the pairs
     of carry_edges (p - 1, p - 2^32, all-ones words, ...) first, exact; 64
     lanes also against Python ints.
  3. comb (kernel B, its table read by u8 one-hot products on the tensor
     cores) against
     comb_plain: Jacobian planes, exact, 65,536 lanes; 512 lanes (edge
     scalars 1, 2, 5, n-2 first) against the oracle.
  4. ladder (kernel A): 512 lanes carrying distinct points (i+1)G against
     the oracle (against group.scalar_mult in phase 6, at full width).
  5. affine conversion (kernel D, a Montgomery batch inversion: G lanes a
     thread, on P-384 and P-521 a block sharing one inversion) against the plain
     JacobianPoint.to_affine on phase 3's 65,536 comb results with lanes
     set to infinity at group edges (a group's first and last lanes, two in
     one group, a whole group, a warp's edge, the batch's last lane); exact;
     then a ragged batch (65,536 - 333 lanes, no multiple of a block's)
     equal to the full run's lanes. Phases 11, 14 and 19 do the same on the
     other curves. A batch that small runs 4 lanes a thread; phases 6, 12,
     15 and 19 repeat the edges and the ragged batch at 524,288 lanes, the
     curve's own G, the last two blocks against to_affine.
  6. the first main path through api.scalar_mult_base and api.scalar_mult
     at B = 524,288: launch counts, CUDA-event times of each kernel, its
     plain version and the end-to-end call, and 64 lanes of each result
     against the oracle.
  7. signed window (kernel E), plain and strict, against window_plain:
     exact on 65,536 lanes; 512 lanes with distinct points (i+1)G against
     the oracle (edge scalars, and n-1 for strict; the plain window's
     documented degenerate lanes, n-2 among them, excluded as bench.py
     excludes them).
  8. strict comb (kernel B strict) against strict comb_plain the same way,
     k = n-1 (result -G) included.
  9. the second main path at B = 524,288: api.scalar_mult_fast (both
     modes), api.scalar_mult_base(strict=True), and ECDH — two parties'
     derive_public_planes, then shared_secret_planes both ways, with a zero
     scalar, scalar = n, an off-curve peer and x = p in the batch: masks
     exact, d1*Q2 == d2*Q1 on every valid lane, 64 lanes against the
     oracle; launch counts; kernels E, E strict and B strict exact against
     their plain versions on the path's own inputs; CUDA-event times of
     each kernel, its plain version and the end-to-end call.
 10. secp256k1 field (kernel C on the Montgomery field) against the plain
     CIOS GFp on 65,536 lanes, carry_edges pairs first, and 64 lanes
     against Python ints.
 11. secp256k1 kernels: GLV (kernel F), plain and strict, against glv_plain
     on 65,536 lanes, and strict against the oracle on 512 lanes with
     distinct points (i+1)G and the lambda-class scalars (1, 2, lambda,
     lambda +- 1, n-1, n-2, splits with k1 = 0 or k2 = 0); comb (B) and
     strict comb on secp256k1 against comb_plain on 65,536 lanes and the
     oracle on 512; affine (D) on secp256k1 against to_affine the same way.
 12. the third main path at B = 131,072 (ECDSA_BATCH, a quarter of the
     deployment size: its time is plain PyTorch), on P-256 and on secp256k1: keys
     Q = d G (api.scalar_mult_base), ecdsa.sign_planes, verify_planes on the
     honest batch (every lane valid) and on a tampered one (r + 1, s = 0,
     s = n, r = 0, an off-curve Q, a hash = n lane, and on secp256k1 a
     valid u2 = lambda lane): masks exact against the oracle on 512 lanes
     and the tampered ones; recover_planes with v = 0 and v = 1, one of
     which gives Q on every lane; 8 P-256 lanes with RFC 6979 A.2.5 nonces
     equal the RFC's signatures. Launch counts, CUDA-event times of each
     call, of its kernels and of its plain-PyTorch parts (the mod-n batch
     inverse, the GLV split, recovery's square root); the new kernels
     against their plain versions on the path's own inputs.
 13. the 2^255 - 19 field (kernel C on the Crandall fold) against the plain
     GFp on 65,536 lanes, edge values included, and 64 lanes against ints.
 14. the X25519 kernels on 65,536 lanes: the x-only ladder (kernel G)
     against mladder_plain, x / z (kernel H) against the plain batch
     inversion, the Wei25519 comb (B) against comb_plain and affine (D)
     against to_affine, all exact; 512 lanes against an RFC 7748 int ladder
     written below; the RFC 7748 §5.2 vectors and iteration 1.
 15. the fourth main path at B = 524,288: X25519 keygen of two parties
     (x25519.derive_public_batch: comb B and affine D on Wei25519) and the
     exchange both ways (x25519.x25519_batch: kernels G and H), with special
     peer u's on some lanes (0, 1, p, p + 1, the top bit set, a point on the
     twist): every other lane's secret equal both ways, 512 lanes and the
     special ones against the int ladder; G, H, B and D against their plain
     versions on the path's own inputs; CUDA-event times of the planes
     calls, the kernels and the plain versions.
 16. the calibration entry point: kernel I against calib_plain at small
     reps, exact; then bench.roofline.measure_int32_ceiling at full reps:
     measured int32 operations and IMADs per second beside the 64 per SM
     per clock that bound() assumes.
 17. the comb's other schedules on P-256: kernels J (pairwise tree) and L
     with chains 2 and 4 (unroll 1 and 2) and with one chain (unroll 2, 4;
     strict, n-1 included) against comb_tree_plain / comb_chains_plain, K
     (pipe) against kernel B, on 65,536 lanes, exact; 512
     lanes of each through kernel D against the oracle, lanes where the
     schedule's composition on ints hits a degenerate add excluded and
     counted. Then the path bench.py times under BENCH_CHAIN / BENCH_UNROLL
     at B = 524,288 on phase 6's scalars: comb.scalar_mult_base(chain,
     chains, unroll) and kernel D for each schedule, launch counts, 64
     lanes against the oracle; each kernel exact against its plain version
     (K: kernel B) on the path's own inputs; L's shared memory at each
     schedule; CUDA-event times of each kernel, of the entry point with D,
     and of the plain versions. Then its B9 part
     (general_phase): kernel L (chains and unroll as run-time
     ints) at chains 8, 32, chains 4 with unroll 2, unroll 8, 32, strict
     unroll 8, 32 on P-256 (phase 6's scalars), and at chains 8 and strict
     unroll 8 on secp256k1 and Wei25519 (edge scalars 1, 2, 5, n-2, n-1
     first), each a path of its own at B = 524,288 through the entry point
     and kernel D (schedule_path): launch counts, 512 lanes against the
     oracle (degenerate lanes of each schedule's composition excluded and
     counted), each schedule exact against comb_chains_plain / comb_plain on
     the path's first 65,536 lanes, the positions staged a step and the
     shared memory (against comb.general_smem_bytes), CUDA-event times.
 18. the main path on secp256k1 and on Wei25519 at B = 524,288 (edge
     scalars 1, 2, 5, n-2, n-1 first; points (i+1)G, lane 0 and every lane
     from 512 on the generator itself): api.scalar_mult (kernel A),
     api.scalar_mult_fast plain and strict (E, E strict),
     api.scalar_mult_shared_fast, and comb.scalar_mult_base with each of
     phase 17's schedules (J, K, L), each followed by kernel D; on Wei25519
     also ECDH (two parties' keys, shared secrets both ways with a zero
     scalar, scalar = n, an off-curve peer and x = p: E strict) and
     api.scalar_mult_base(strict=True) (B strict). ECDSA is not run there:
     the JAX package and the port refuse it on Wei25519, whose order n has
     253 bits (ecdsa.curve_order_big_enough: a 256-bit hash is reduced mod
     n by one subtraction, so 2n > 2^256 is required). Launch counts; 512 lanes
     of each result against the oracle (each schedule's and the plain
     window's degenerate lanes, and n-1 on the ladder, excluded and
     counted); masks exact; each new kernel exact against its plain
     version, or kernel B for K and one-chain L, on the first 65,536 lanes
     of the path's own inputs (all 524,288 before phase 19 was added; the
     plain versions in the plain pool, beside the path);
     CUDA-event times of each kernel at 524,288 lanes, of the entry points
     and of the plain versions.
 19. the main path on P-384 and on P-521 at B = 524,288 (edge scalars 1, 2,
     5, n-2, n-1 first; points (i+1)G, lane 0 and every lane from 512 on
     G): api.scalar_mult (kernel A), api.scalar_mult_fast plain and strict
     (E, E strict), api.scalar_mult_shared_fast, api.scalar_mult_base plain
     and strict (B, B strict), each followed by kernel D, and ECDH (two
     parties' keys, shared secrets both ways with a zero scalar, scalar =
     n, an off-curve peer and x = p); on P-384 also ECDSA sign / verify /
     recover at 131,072 lanes with 384-bit hashes (phase 12's checks). P-521
     ECDSA is refused by the JAX package and the port alike (its n has 521
     bits of the planes' 528: ROADMAP C7). Launch counts; 512 lanes of each
     result against the oracle (the plain window's and the serial comb's
     degenerate lanes, and n-1 on the ladder, excluded and counted); masks
     exact; kernels A, B, B strict, D, E and E strict exact against their
     plain versions on the first 65,536 lanes of the path's own inputs,
     kernel C against probe_plain (edge pairs first) and 64 lanes against
     ints; CUDA-event times of each kernel at 524,288 lanes, of the entry
     points, and of the plain versions. E's table is split between shared
     memory and a scratch (kernels/window.table_split): its persistent
     grid of SMs x 4 blocks of 64 threads walks 65,536 and 524,288 lanes
     over 33,792 scratch columns on an H100; the kernels line gives each
     wide E's blocks an SM (its source's _occupancy query, checked against
     the split's four) and the scratch's bytes.
 20. the comb's schedules on P-384 and on P-521 at B = 524,288
     (wide_schedule_phase; edge scalars 1, 2, 5, n-2, n-1 first): the tree
     (kernel J, its walk the table of comb_tree_schedule.cuh), the pipe
     (K), and kernel L at chains 2, 3 and npos, unroll 2 and
     npos, strict unroll 2 and npos (and on P-384 chains 4, chains 2 with
     unroll 2, which P-521 refuses with ValueError, as the JAX package
     does), each through comb.scalar_mult_base and kernel D, each curve a
     path of its own (schedule_path, as phase 17's B9 part).
 21. multi-scalar multiplication, the shared-scalar ladder and SEC1 on all
     five curves (msm_phase), each a path of its own at B = 524,288 on
     points c_i G from the strict comb: api.multi_scalar_mult (E strict, or
     F strict on secp256k1, then kernel M, the whole tree in one cooperative
     launch: 2 launches a path), with lanes i and i + B/2 equal pairs (4,096)
     and opposite pairs (4,096), its sum against the oracle's (sum k_i c_i
     mod n) G, and a second batch whose sum is infinity;
     api.scalar_mult_shared (k + 2^nbits: kernel A on the broadcast planes of
     k, then D), 512 lanes against the oracle; encoding.points_to_bytes /
     points_from_bytes on 65,536 mixed SEC1 encodings, 128 of them invalid (8
     forms), masks and points exact. Launch counts; kernel M word for word
     against the plain complete add on the first level's 262,144 lanes
     (levels = 1), against the plain batch_sum's final lane and the path's
     sum, and against the plain batch_sum at the sizes where its grid hands
     off to one block (2, 3, the block's threads +- 1, twice them +- 1), 1,001
     and 524,287 lanes, on the path's own per-lane products (on Wei25519
     also with its point of order 2); CUDA-event times of M's tree (five
     runs of 20), its first level and its depth floor (trees of 2^k lanes,
     each call alone: bench/tree.py's depth_floor from lone one-launch
     calls, the profiler off), of the plain versions and of the entry
     points.

Inputs come from numpy.random.default_rng(SEED). The line before the last
is a JSON object with one entry per kernel; the last line is the device
summary ``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import ctypes
import functools
import hashlib
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ecsimd_tpu_torch import api, convert, ecdh, ecdsa, encoding, glv, x25519
from ecsimd_tpu_torch.bench import roofline, sass
from ecsimd_tpu_torch.bench import tree as btree
from ecsimd_tpu_torch.curves import group
from ecsimd_tpu_torch.curves.point import AffinePoint, JacobianPoint
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import _build, affine, batch_sum, comb, field_ops, ladder, mladder
from ecsimd_tpu_torch.kernels import window
from ecsimd_tpu_torch.kernels import glv as kglv
from ecsimd_tpu_torch.ops import mont
from ecsimd_tpu_torch.oracle import comb as ocomb
from ecsimd_tpu_torch.oracle import coz
from ecsimd_tpu_torch.oracle import field as ofield
from ecsimd_tpu_torch.oracle import window as ow
from ecsimd_tpu_torch.specs import P256, P384, P521, SECP256K1, W25519_FIELD, WEI25519

SEED = 0xEC51
BATCH = 524288  # bench.py's deployment size
# phase 12, ECDSA: its calls are 94-99 % plain PyTorch whose time grows with
# the batch; run at a quarter of the deployment size since phase 18 was
# added, to keep the whole run near half its time limit
ECDSA_BATCH = BATCH // 4
CHECK_LANES = 65536  # kernel against plain version, exact
ORACLE_LANES = 512  # against the Python-int oracle, as bench.py verifies
MAIN_ORACLE_LANES = 64
D = P256.field.ndigits
N, P = P256.order, P256.p
EDGE_SCALARS = [1, 2, 5, N - 2]
# kernel name in the JSON line -> the part of the CUDA kernel's (mangled)
# name by which -Xptxas -v reports it
PTXAS_NAMES = {k: f"{v}_kernel" for k, v in {
    "comb": "comb_p256", "comb_strict": "comb_strict_p256", "ladder": "ladder_p256",
    "window": "window_p256", "window_strict": "window_strict_p256", "affine": "affine_p256",
    "field_probe": "field_probe_p256", "comb_secp256k1": "comb_secp256k1",
    "comb_strict_secp256k1": "comb_strict_secp256k1", "affine_secp256k1": "affine_secp256k1",
    "field_probe_secp256k1": "field_probe_secp256k1", "glv": "glv_secp256k1",
    "glv_strict": "glv_strict_secp256k1", "mladder": "mladder_w25519",
    "x25519_xdivz": "xdivz_w25519", "comb_w25519": "comb_w25519",
    "affine_w25519": "affine_w25519", "field_probe_w25519": "field_probe_w25519",
    "calib": "calib", "comb_tree": "comb_tree_p256", "comb_pipe": "comb_pipe_p256",
}.items()}
# kernel L at comb.SCHEDULES_L, phases 17 and 18: JSON name -> (chains,
# unroll, strict), and the entry point's keyword arguments
SCHEDULES_L = {
    "comb_chains2": (2, 1, False), "comb_chains2_unroll2": (2, 2, False),
    "comb_chains4": (4, 1, False), "comb_unroll2": (1, 2, False), "comb_unroll4": (1, 4, False),
    "comb_unroll2_strict": (1, 2, True), "comb_unroll4_strict": (1, 4, True),
}
PTXAS_NAMES |= {k: f"comb_general{'_strict' if st else ''}_p256_kernel"
                for k, (c, u, st) in SCHEDULES_L.items()}
SCHEDULES = {"comb_tree": {"chain": "tree"}, "comb_pipe": {"chain": "pipe"}} | {
    k: {"chains": c, "unroll": u, "strict": st} for k, (c, u, st) in SCHEDULES_L.items()}
# phase 18: the curves beyond P-256 and their tag in the C names
CURVES18 = {c: _build.CURVE_TAGS[c][0] for c in _build.CURVES_256 if c != P256}


def curve_kernels(curve):
    """Phase 18's kernels on ``curve``: JSON name -> kernel."""
    tag = CURVES18[curve]
    out = {f"ladder_{tag}": ladder.KERNELS[curve], f"window_{tag}": window.KERNELS[(curve, False)],
           f"window_strict_{tag}": window.KERNELS[(curve, True)]}
    if curve == WEI25519:
        out["comb_strict_w25519"] = comb.KERNELS[(curve, True)]
    out[f"comb_tree_{tag}"] = comb.KERNELS_TREE[curve]
    out[f"comb_pipe_{tag}"] = comb.KERNELS_PIPE[curve]
    out |= {f"{k}_{tag}": comb.KERNELS_GENERAL[(curve, st)]
            for k, (_, _, st) in SCHEDULES_L.items()}
    return out


for _tag in CURVES18.values():
    PTXAS_NAMES |= {f"{k}_{_tag}": f"{k}_{_tag}_kernel"
                    for k in ("ladder", "window", "window_strict", "comb_tree", "comb_pipe")}
    PTXAS_NAMES |= {f"{k}_{_tag}": f"comb_general{'_strict' if st else ''}_{_tag}_kernel"
                    for k, (c, u, st) in SCHEDULES_L.items()}
PTXAS_NAMES["comb_strict_w25519"] = "comb_strict_w25519_kernel"
# phase 21: kernel M on every curve
PTXAS_NAMES |= {("batch_sum" if t == "p256" else f"batch_sum_{t}"): f"batch_sum_{t}_kernel"
                for t, _ in _build.CURVE_TAGS.values()}
# phase 19: P-384 and P-521 and their tag in the C names
CURVES19 = {c: _build.CURVE_TAGS[c][0] for c in _build.WIDE_CURVES}
WIDE_KINDS = ("ladder", "window", "window_strict", "comb", "comb_strict", "affine", "field_probe",
              "field_consts")
for _tag in CURVES19.values():
    PTXAS_NAMES |= {f"{k}_{_tag}": f"{k}_{_tag}_kernel" for k in WIDE_KINDS}


def wide_kernels(curve):
    """Phase 19's kernels on ``curve``: JSON name -> kernel."""
    tag = CURVES19[curve]
    return {f"ladder_{tag}": ladder.KERNELS[curve],
            f"window_{tag}": window.KERNELS[(curve, False)],
            f"window_strict_{tag}": window.KERNELS[(curve, True)],
            f"comb_{tag}": comb.KERNELS[(curve, False)],
            f"comb_strict_{tag}": comb.KERNELS[(curve, True)],
            f"affine_{tag}": affine.KERNELS[curve],
            f"field_probe_{tag}": field_ops.KERNELS[curve.field],
            f"field_consts_{tag}": field_ops.KERNELS_CONSTS[curve.field]}



def schedule_name(chains, unroll, strict):
    """JSON name of kernel L at a schedule (without a curve's
    tag)."""
    return ("comb_general" + (f"_chains{chains}" if chains > 1 else "")
            + (f"_unroll{unroll}" if unroll > 1 else "") + ("_strict" if strict else ""))


def general_schedules(triples):
    """JSON name -> the entry point's keyword arguments, for (chains,
    unroll, strict) triples."""
    return {schedule_name(c, u, st): {"chains": c, "unroll": u, "strict": st}
            for c, u, st in triples}


# phase 17, its B9 part: kernel L at larger schedules than SCHEDULES_L's;
# all on P-256, B9_OTHER on secp256k1 and Wei25519
SCHEDULES_B9 = general_schedules(((8, 1, False), (32, 1, False), (4, 2, False), (1, 8, False),
                                  (1, 32, False), (1, 8, True), (1, 32, True)))
B9_OTHER = ("comb_general_chains8", "comb_general_unroll8_strict")


def wide_schedules(curve):
    """Phase 20's schedules on P-384 or P-521: JSON name (without the tag)
    -> the entry point's keyword arguments. The tree, the pipe, and the
    kernel L at chains 2, 3 and npos, unroll 2 and npos, strict
    unroll 2 and npos; on P-384 also chains 4 and chains 2 with unroll 2,
    which P-521 (66 positions) refuses (WIDE_REFUSED)."""
    npos = curve.field.nbits // comb.W
    triples = [(2, 1, False), (3, 1, False), (npos, 1, False), (1, 2, False), (1, npos, False),
               (1, 2, True), (1, npos, True)]
    if curve == P384:
        triples += [(4, 1, False), (2, 2, False)]
    return {"comb_tree": {"chain": "tree"}, "comb_pipe": {"chain": "pipe"},
            **general_schedules(triples)}


WIDE_REFUSED = {P521: ({"chains": 4}, {"chains": 2, "unroll": 2})}
# curve -> the schedules of its path in phase 17's B9 part or in phase 20
PATH_SCHEDULES = {P256: SCHEDULES_B9, SECP256K1: {k: SCHEDULES_B9[k] for k in B9_OTHER},
                  WEI25519: {k: SCHEDULES_B9[k] for k in B9_OTHER},
                  P384: wide_schedules(P384), P521: wide_schedules(P521)}


def schedule_kernel(curve, kw):
    """The kernel comb.scalar_mult_base(..., curve, **kw) launches on CUDA
    tensors (kw not the serial chain with one chain at unroll 1)."""
    if kw.get("chain") == "tree":
        return comb.KERNELS_TREE[curve]
    if kw.get("chain") == "pipe":
        return comb.KERNELS_PIPE[curve]
    return comb.KERNELS_GENERAL[(curve, kw.get("strict", False))]


def tagged(curve, name):
    """A kernels-line name on ``curve``: P-256's bare, the others' with the
    curve's tag."""
    return name if curve == P256 else f"{name}_{_build.CURVE_TAGS[curve][0]}"


# RFC 6979 A.2.5, P-256 with SHA-256: private key x, and (message, k, r, s)
RFC6979_X = 0xC9AFA9D845BA75166B5C215767B1D6934E50C3DB36E89B127B8A622B120F6721
RFC6979_SHA256 = [
    (b"sample", 0xA6E3C57DD01ABE90086538398355DD4C3B17AA873382B0F24D6129493D8AAD60,
     0xEFD48B2AACB6A8FD1140DD9CD45E81D69D2C877B56AAF991C34D0EA84EAF3716,
     0xF7CB1C942D657C41D436C7A1B6E29F65F3E900DBB9AFF4064DC4AB2F843ACDA8),
    (b"test", 0xD16B6AE827F17175E040871A1C7EC3500192C4C92677336EC2537ACAEE0008E0,
     0xF1ABB023518351CD71D881567B1EA663ED3EFCF6C5132B354F28D3B0B7D38367,
     0x019F4113742A2B14BD25926B49C649155F267E60D3814B4C0CC84250E46F0083),
]

# The least time the card could take for a kernel's work (bound_ms): the
# larger of its bytes over the memory rate and its 32-bit multiply-adds over
# the IMAD rate. Field multiplies (M) and squarings (S) per formula, counted
# in csrc/coz.cuh, coz_p256.cuh, coz_secp256k1.cuh, coz_w25519.cuh,
# jacobian.cuh and the field headers; each curve is charged its own doubling
# (a = -3: 3M + 5S; secp256k1, a = 0: 1M + 7S; Wei25519, general a:
# 2M + 8S) and the complete add that calls it. An inversion z^(p - 2) is charged the shortest known addition
# chain, not the kernels' square-and-multiply: 255 S + 12 M on P-256 (runs
# of 32, 1 and 94 ones), 255 S + 15 M on secp256k1 (libsecp256k1's chain).
# Kernel D is charged the reference's own algorithm (GFp.batch_inverse,
# Montgomery's trick): 3 M a lane, the tail, and one inversion a launch
# (ONCE_MS), not one a lane.
# Every kernel is constant-time, so the count does not depend on the data.
FORMULA_MS = {
    "add_z2_1": (7, 4), "zdau": (9, 7), "tplu": (6, 7), "jac_dbl": (3, 5),
    "jac_add": (12, 4), "aff_add": (4, 2), "add_complete": (15, 9), "fe_inv": (12, 255),
    "affine_tail": (3, 1),  # z^-2, then x z^-2 and y z^-2 z^-1
    "batch_trick": (3, 0),  # a lane's share of Montgomery's trick
    "probe": (1, 1),
    # secp256k1 (a = 0): dbl-2007-bl 1M + 7S; the complete add is jac_add
    # + that doubling; to_classical is 1M per output
    "k1_jac_dbl": (1, 7), "k1_add_complete": (13, 11), "k1_fe_inv": (15, 255),
    "k1_affine_tail": (5, 1), "beta": (1, 0),
    # 2^255 - 19: the ladder step (5M + 4S, a24 e counted apart), the
    # addition chain z^(p - 2) (254 S + 11 M) and kernel H's x z^-1;
    # Wei25519's doubling (general a) and complete add
    "ladder_step": (5, 4), "w_fe_inv": (11, 254), "xdivz": (12, 254),
    "w_jac_dbl": (2, 8), "w_add_complete": (14, 12),
    # P-384 and P-521 (a = -3, the P-256 formulas): the addition chains of
    # field_p384.cuh and field_p521.cuh
    "p384_fe_inv": (14, 385), "p521_fe_inv": (13, 524),
}
# curve tag -> its doubling and complete add in FORMULA_MS
CURVE_FORMULAS = {"p256": ("jac_dbl", "add_complete"), "secp256k1": ("k1_jac_dbl",
                  "k1_add_complete"), "w25519": ("w_jac_dbl", "w_add_complete")}


def lane_ms(*terms):
    """(M, S) per lane for (count, formula) pairs."""
    return tuple(sum(n * FORMULA_MS[f][i] for n, f in terms) for i in (0, 1))


def schedule_ms(tag):
    """(M, S) per lane of the variable-base kernels and the comb's
    schedules on the curve ``tag``, by JSON name without the tag."""
    dbl, add_c = CURVE_FORMULAS[tag]
    return {
        "ladder": lane_ms((1, "tplu"), (254, "zdau"), (1, "add_z2_1")),
        "window": lane_ms((257, dbl), (71, "jac_add"), (1, "add_z2_1")),
        "window_strict": lane_ms((257, dbl), (7, "jac_add"), (65, add_c)),
        "comb_strict": lane_ms((32, add_c)),
        # the tree's 16 affine adds, 15 general adds and the fix-up; c
        # chains' 32 - c mixed adds, c - 1 general adds and the fix-up; the
        # pipe and one chain at any unroll, the serial chain's 32 mixed adds
        "comb_tree": lane_ms((16, "aff_add"), (15, "jac_add"), (1, "add_z2_1")),
        "comb_pipe": lane_ms((32, "add_z2_1")),
        **{k: lane_ms((33 - c, "add_z2_1"), (c - 1, "jac_add")) if not st
           else lane_ms((32, add_c)) for k, (c, _, st) in SCHEDULES_L.items()},
    }


GLV_WINDOWS = 4 * kglv.KERNEL_DIGITS  # 36 windows of 4 doublings and two adds
LANE_MS = {
    "comb": lane_ms((32, "add_z2_1")),
    "comb_strict": lane_ms((32, "add_complete")),
    **{k: v for k, v in schedule_ms("p256").items()
       if k in ("ladder", "window", "window_strict")},
    "affine": lane_ms((1, "batch_trick"), (1, "affine_tail")),
    "field_probe": lane_ms((1, "probe")),
    "comb_secp256k1": lane_ms((32, "add_z2_1")),
    "comb_strict_secp256k1": lane_ms((32, "k1_add_complete")),
    "affine_secp256k1": lane_ms((1, "batch_trick"), (1, "k1_affine_tail")),
    "field_probe_secp256k1": lane_ms((1, "probe")),
    # table (1 dbl + 7 adds), beta x of the 8 entries, the first add, 36
    # windows (4 dbl, 2 adds), 2 fix-ups
    "glv": lane_ms((1, "k1_jac_dbl"), (7, "jac_add"), (kglv.TABLE, "beta"), (1, "jac_add"),
                   (4 * GLV_WINDOWS, "k1_jac_dbl"), (2 * GLV_WINDOWS, "jac_add"),
                   (2, "add_z2_1")),
    "glv_strict": lane_ms((1, "k1_jac_dbl"), (7, "jac_add"), (kglv.TABLE, "beta"),
                          (1, "k1_add_complete"), (4 * GLV_WINDOWS, "k1_jac_dbl"),
                          (2 * GLV_WINDOWS, "k1_add_complete"), (2, "k1_add_complete")),
    "mladder": lane_ms((255, "ladder_step")),
    "x25519_xdivz": lane_ms((1, "xdivz")),
    "comb_w25519": lane_ms((32, "add_z2_1")),
    "affine_w25519": lane_ms((1, "batch_trick"), (1, "affine_tail")),
    "field_probe_w25519": lane_ms((1, "probe")),
    # phase 17
    **{k: v for k, v in schedule_ms("p256").items() if k in SCHEDULES},
    # phase 18: every kernel of curve_kernels, on its own curve's formulas
    **{f"{k}_{tag}": v for tag in CURVES18.values() for k, v in schedule_ms(tag).items()
       if k != "comb_strict" or tag == "w25519"},
}


def wide_ms(tag, d):
    """(M, S) per lane of phase 19's kernels on P-384 / P-521 (``d``
    digits, 16 d bits): the ladder's 16 d - 2 ZDAU steps, the window's 4 d
    windows (4 doublings and an add each; the table's doubling and 7 adds),
    the comb's 2 d positions (the fix-up included), the inversion chain."""
    windows = 4 * d
    return {
        f"ladder_{tag}": lane_ms((1, "tplu"), (16 * d - 2, "zdau"), (1, "add_z2_1")),
        f"window_{tag}": lane_ms((1 + 4 * windows, "jac_dbl"), (7 + windows, "jac_add"),
                                 (1, "add_z2_1")),
        f"window_strict_{tag}": lane_ms((1 + 4 * windows, "jac_dbl"), (7, "jac_add"),
                                        (windows + 1, "add_complete")),
        f"comb_{tag}": lane_ms((2 * d, "add_z2_1")),
        f"comb_strict_{tag}": lane_ms((2 * d, "add_complete")),
        f"affine_{tag}": lane_ms((1, "batch_trick"), (1, "affine_tail")),
        f"field_probe_{tag}": lane_ms((1, "probe")),
        # kernel C's constant-operand form: one lane, 2 multiplies, 2 squarings
        f"field_consts_{tag}": lane_ms((2, "probe")),
    }


for _c, _tag in CURVES19.items():
    LANE_MS |= wide_ms(_tag, _c.field.ndigits)


# (M, S) a launch, whatever its lanes: kernel D's one inversion of the batch
ONCE_MS = {"affine": FORMULA_MS["fe_inv"], "affine_secp256k1": FORMULA_MS["k1_fe_inv"],
           "affine_w25519": FORMULA_MS["w_fe_inv"],
           **{f"affine_{t}": FORMULA_MS[f"{t}_fe_inv"] for t in CURVES19.values()}}


def schedules_ms(curve, schedules):
    """(M, S) per lane of the comb schedules ``schedules`` (JSON name ->
    keyword arguments) on ``curve``, by kernels-line name: the tree's npos/2
    affine adds, npos/2 - 1 general adds and the fix-up; the pipe's npos
    mixed adds (the fix-up one of them); c chains' npos - c mixed adds, c - 1
    general adds and the fix-up; strict, npos complete adds."""
    npos = curve.field.nbits // comb.W
    tag = _build.CURVE_TAGS[curve][0]
    add_c = CURVE_FORMULAS.get(tag, CURVE_FORMULAS["p256"])[1]
    out = {}
    for name, kw in schedules.items():
        c = kw.get("chains", 1)
        if kw.get("chain") == "tree":
            ms = lane_ms((npos // 2, "aff_add"), (npos // 2 - 1, "jac_add"), (1, "add_z2_1"))
        elif kw.get("strict"):
            ms = lane_ms((npos, add_c))
        else:
            ms = lane_ms((npos + 1 - c, "add_z2_1"), (c - 1, "jac_add"))
        out[tagged(curve, name)] = ms
    return out


for _c, _kws in PATH_SCHEDULES.items():
    LANE_MS |= schedules_ms(_c, _kws)

# 32 x 32 -> 64-bit products, two 32-bit multiply-adds each. A multiply has
# 8 x 8 products, a squaring 36 (8 squares, 28 cross products taken once).
# The reduction: none on P-256 (Solinas: adds only); on secp256k1 the least
# the function needs, not the kernels' word-by-word REDC (8 x 2 products): p =
# 2^256 - 2^32 - 977, so the high half folds in as hi * 977 (8 products)
# plus a shift, and the fold's carry word once more (1 product).
# On 2^255 - 19 the same: the high half folds in as hi * 38 (8 products)
# and the carry word once more (1); the ladder's a24 e is a small multiply,
# 8 products and that 1-product fold, once per bit.
IMADS_PER_MUL, IMADS_PER_SQR = 2 * 64, 2 * 36
FOLD_IMADS = 2 * (8 + 1)
FOLD_FIELD = {"glv", "glv_strict", "mladder", "x25519_xdivz"} | {
    k for k in LANE_MS if k.endswith(tuple(CURVES18.values()))}
SMALL_IMADS = {"mladder": 255 * 2 * (8 + 1)}
PLANE_BYTES = D * 4  # one (16,) int32 digit column per lane
BYTES_PER_LANE = {  # each input plane read once, each output plane written once
    "comb": 4 * PLANE_BYTES, "comb_strict": 4 * PLANE_BYTES, "ladder": 6 * PLANE_BYTES,
    "window": 6 * PLANE_BYTES, "window_strict": 6 * PLANE_BYTES, "affine": 5 * PLANE_BYTES,
    "field_probe": 7 * PLANE_BYTES,
    "comb_secp256k1": 4 * PLANE_BYTES, "comb_strict_secp256k1": 4 * PLANE_BYTES,
    "affine_secp256k1": 5 * PLANE_BYTES, "field_probe_secp256k1": 7 * PLANE_BYTES,
    "glv": 5 * PLANE_BYTES + (2 * kglv.KERNEL_DIGITS + 2) * 4,
    "glv_strict": 5 * PLANE_BYTES + (2 * kglv.KERNEL_DIGITS + 2) * 4,
    "mladder": 4 * PLANE_BYTES, "x25519_xdivz": 3 * PLANE_BYTES,
    "comb_w25519": 4 * PLANE_BYTES, "affine_w25519": 5 * PLANE_BYTES,
    "field_probe_w25519": 7 * PLANE_BYTES, "calib": 3 * 4,  # per element: a, b, out
    **{k: 4 * PLANE_BYTES for k in SCHEDULES},
    **{f"{k}_{tag}": (6 if k.startswith(("ladder", "window")) else 4) * PLANE_BYTES
       for tag in CURVES18.values() for k in schedule_ms(tag)},
}
COMB_TABLE_BYTES = (256 + 31 * 128) * 16 * 4  # kernel B's limb layout
# P-384 and P-521: a multiply has N^2 products, a squaring N (N + 1) / 2 (N =
# 12, 17 words), two multiply-adds each; both reductions are adds and
# shifts. Each input plane of D digits read once, each output written once;
# the comb's tables in their padded limb layout.
WIDE_IMADS = {}
for _c, _tag in CURVES19.items():
    _d = _c.field.ndigits
    _w = (_d + 1) // 2
    WIDE_IMADS[_tag] = (2 * _w * _w, _w * (_w + 1))
    BYTES_PER_LANE |= {f"{k}_{_tag}": n * _d * 4 for k, n in (
        ("ladder", 6), ("window", 6), ("window_strict", 6), ("comb", 4), ("comb_strict", 4),
        ("affine", 5), ("field_probe", 7), ("field_consts", len(field_ops.CONST_OPS)))}
    BYTES_PER_LANE[f"comb_table_{_tag}"] = (
        (comb.NENT + (2 * _d - 1) * comb.NENT // 2) * 2 * comb.coord_words(_d) * 4)
# phase 17's B9 part and phase 20: the ptxas name of each schedule's kernel,
# and its bytes (scalars in, three coordinates out)
for _c, _kws in PATH_SCHEDULES.items():
    for _k in _kws:
        _kind = _k if _k in ("comb_tree", "comb_pipe") else (
            "comb_general_strict" if _k.endswith("_strict") else "comb_general")
        PTXAS_NAMES[tagged(_c, _k)] = f"{_kind}_{_build.CURVE_TAGS[_c][0]}_kernel"
        BYTES_PER_LANE[tagged(_c, _k)] = 4 * _c.field.ndigits * 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak memory bandwidth
IMAD_PER_SM_PER_CLOCK = 64  # CUDA C++ Programming Guide, compute capability 9.0
SMS = 132


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# The oracle's Python-int work (512 lanes of each result, the degenerate-lane
# searches) runs on the host's cores, in a pool of spawned processes that
# main() starts before the build and shuts down at its end; without one
# (an import of this module) it runs in this process.
ORACLE_WORKERS = min(8, os.cpu_count() or 1)
_POOL = None
# Phase 19's plain versions are launch-bound Python (the plain P-521 ladder
# takes a minute at any width), so each runs in a process of its own with
# its own CUDA context, beside the phase's path and checks: a second pool.
PLAIN_WORKERS = 6
_PLAIN_POOL = None
_T0 = time.perf_counter()


def pmap(fn, args):
    """[fn(*a) for a in args], in order, on the oracle pool if there is one."""
    args = list(args)
    if _POOL is None or len(args) < 2:
        return [fn(*a) for a in args]
    chunk = max(1, len(args) // (4 * ORACLE_WORKERS))
    return list(_POOL.map(fn, *zip(*args), chunksize=chunk))


def plain_job(kind, curve, strict, arrays, device, chains=1):
    """One plain version on ``device`` (a pool process): ``kind`` ladder,
    window, comb, comb_tree, comb_chains (``chains`` chains) or affine on
    the int32 numpy planes ``arrays``. Returns its output planes as numpy
    and its milliseconds (CUDA events)."""
    dev = torch.device(device)
    fs = curve.field
    ts = [torch.from_numpy(a).to(dev) for a in arrays]
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    if kind == "ladder":
        s, x, y = ts
        jac = group.scalar_mult(s, JacobianPoint(GFp(x, fs), GFp(y, fs), GFp.one(fs, x), curve))
        out = (jac.x.planes, jac.y.planes, jac.z.planes)
    elif kind == "window":
        out = window.window_plain(*ts, curve, strict)
    elif kind.startswith("comb"):
        tables, negbase, _ = comb.device_tables(curve, curve.gx, curve.gy, dev)
        if kind == "comb_tree":
            out = comb.comb_tree_plain(ts[0], tables, curve, negbase)
        elif kind == "comb_chains":
            out = comb.comb_chains_plain(ts[0], tables, curve, negbase, chains)
        else:
            out = comb.comb_plain(ts[0], tables, curve, negbase, strict)
    else:
        pt = JacobianPoint(*(GFp(v, fs) for v in ts), curve).to_affine()
        out = (pt.x, pt.y)
    if cuda:
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
    else:
        ms = (time.perf_counter() - t0) * 1e3
    return [o.cpu().numpy() for o in out], ms


def plain_submit(*args):
    """plain_job on the plain pool (in this process, when there is none): a
    future."""
    if _PLAIN_POOL is None:
        done = concurrent.futures.Future()
        done.set_result(plain_job(*args))
        return done
    return _PLAIN_POOL.submit(plain_job, *args)


def say(msg):
    """A phase's line, with the seconds since the script started."""
    print(f"{msg} [t = {time.perf_counter() - _T0:.1f} s]", flush=True)


class Counts(dict):
    """{symbol: launches} of one path, and ``shapes``: {symbol: {(lanes,
    *ints): launches}}, the same launches by the lanes and ints each had
    (``_build.Kernel.count``)."""

    def __init__(self, launches=(), shapes=None):
        super().__init__(launches)
        self.shapes = shapes if shapes is not None else {}


def zero_counts(counted):
    """Set every kernel's launch counts to 0: just before a path is driven."""
    for k in counted:
        k.reset()


def read_counts(counted):
    """The launch counts of the path just driven, as ``Counts``."""
    return Counts({k.symbol: k.launches for k in counted},
                  {k.symbol: dict(k.shapes) for k in counted})


def sum_counts(parts):
    """The ``Counts`` of several paths' runs together."""
    out = Counts()
    for c in parts:
        for sym, n in c.items():
            out[sym] = out.get(sym, 0) + n
        for sym, shapes in c.shapes.items():
            mine = out.shapes.setdefault(sym, {})
            for key, n in shapes.items():
                mine[key] = mine.get(key, 0) + n
    return out


def dynamic_smem(kernel):
    """{"dynamic_smem_bytes": n}: the dynamic shared memory the runtime gives
    a block of ``kernel`` (ptxas reports only the static part), read from
    its source's ``<symbol>_smem`` query, and where its source has a
    ``<symbol>_blocks`` query (kernels B, J, K and L; G, launched with
    none) "blocks_per_sm", the blocks an SM holds at that size; {} for a
    kernel with neither query. Kernels B, J and K are held to
    ``comb.serial_smem_bytes``, ``tree_smem_bytes`` and
    ``pipe_smem_bytes``."""
    lib = _build.library().lib
    out = {}
    if hasattr(lib, kernel.symbol + "_smem"):
        fn = getattr(lib, kernel.symbol + "_smem")
        fn.argtypes, fn.restype = [], ctypes.c_int
        out["dynamic_smem_bytes"] = n = fn()
        check(n > 0, f"{kernel.symbol}: dynamic shared memory query gave {n}")
    for table, size in ((((c, k) for (c, _), k in comb.KERNELS.items()), comb.serial_smem_bytes),
                        (comb.KERNELS_TREE.items(), comb.tree_smem_bytes),
                        (comb.KERNELS_PIPE.items(), comb.pipe_smem_bytes)):
        curve = next((c for c, k in table if k is kernel), None)
        if curve is not None:  # B, K: two buffers; J: a step's two positions, double buffered
            n = out["dynamic_smem_bytes"]
            check(n == size(curve), f"{kernel.symbol}: {n} bytes of shared memory, "
                                    f"{size.__name__} says {size(curve)}")
    if hasattr(lib, kernel.symbol + "_blocks"):
        fn = getattr(lib, kernel.symbol + "_blocks")
        fn.argtypes, fn.restype = [], ctypes.c_int
        out["blocks_per_sm"] = fn()
        check(out["blocks_per_sm"] > 0, f"{kernel.symbol}: {out['blocks_per_sm']} blocks an SM")
    return out


def general_smem(curve, name, kernel, kw):
    """Kernel L's positions staged a step and its dynamic shared memory (and
    blocks an SM) at the schedule ``kw`` it last ran, the memory held to
    comb.general_smem_bytes."""
    torch.cuda.synchronize()
    smem = dynamic_smem(kernel)
    want = comb.general_smem_bytes(curve, kw["unroll"])
    check(smem["dynamic_smem_bytes"] == want, f"{curve.name} {name}: "
          f"{smem['dynamic_smem_bytes']} bytes of shared memory, general_smem_bytes says {want}")
    return {"group": comb.general_group(curve, kw["unroll"]), **smem}


def staged_smem(rows):
    """{name: [positions a step, shared memory bytes]} of kernel L's rows."""
    return {k: [v["group"], v["dynamic_smem_bytes"]] for k, v in rows.items() if "group" in v}


def table_split(kernel, dev):
    """For a kernel E on P-384 / P-521 (its table split between shared memory
    and a scratch): the blocks an SM its source's ``_occupancy`` query
    grants (at least the split's four of 64 threads: eight warps), the
    entries on chip, the scratch's bytes a slot and in all; {} for any
    other kernel."""
    curve = next((c for (c, _), k in window.KERNELS.items() if k is kernel), None)
    if curve not in window.SPLITS:
        return {}
    sp = window.table_split(curve)
    blocks = window.occupancy(kernel.symbol)
    check(blocks >= sp.blocks, f"{kernel.symbol}: {blocks} blocks an SM, the split wants "
                               f"{sp.blocks}")
    slots = window.resident_slots(kernel, curve, dev)
    return {"blocks_per_sm": blocks, "warps_per_sm": blocks * sp.threads // 32,
            "table_entries_on_chip": sp.on_chip, "scratch_bytes_per_slot": sp.scratch_bytes,
            "scratch_slots": slots, "scratch_bytes": sp.scratch_bytes * slots}


def carry_edges(p):
    """Field values that take the field layer's carry paths: 0, 1, 2, p - 1,
    p - 2, p - 2^32, a top word of all ones over zeros, all-ones words
    under a top word of 0xFFFFFFFE, alternating all-ones words, 2^255 and
    2^255 - 1. Every pair goes through the probe's mul, add and sub, and
    each value through its sqr (the squares of top words 0xFFFFFFFF)."""
    ones = (1 << 256) - 1
    vals = [0, 1, 2, p - 1, p - 2, p - (1 << 32), 0xFFFFFFFF << 224, ones - (1 << 224),
            sum(0xFFFFFFFF << (64 * i) for i in range(4)), 1 << 255, (1 << 255) - 1]
    return [v for v in vals if v < p]


def random_planes(rng, n):
    """(16, n) int32 digit planes of values below 0xFFFF * 2^240 < p."""
    planes = rng.integers(0, 1 << 16, size=(D, n), dtype=np.int64)
    planes[D - 1] = rng.integers(0, 0xFFFF, size=n)
    return planes.astype(np.int32)


def scalar_ints(rng, n, edges=EDGE_SCALARS, curve=P256):
    """bench.py's draw: uniform mod n (0 -> 1), edge scalars in the first lanes
    (32 random bytes a scalar on the 256-bit curves, 8 more than n's on
    P-384 and P-521)."""
    bits = curve.order.bit_length()
    nbytes = 32 if bits <= 256 else (bits + 7) // 8 + 8
    raw = rng.bytes(nbytes * n)  # one draw: a call a lane took seconds at 524,288 lanes
    ks = [int.from_bytes(raw[i:i + nbytes], "little") % curve.order or 1
          for i in range(0, nbytes * n, nbytes)]
    ks[: len(edges)] = edges
    return ks


def scalar_planes(rng, n, edges=EDGE_SCALARS, curve=P256):
    return convert.ints_to_planes(scalar_ints(rng, n, edges, curve), D)


def to_dev(ints, dev, d=D):
    return torch.from_numpy(convert.ints_to_planes(ints, d)).to(dev)


@functools.cache
def multiples_of_g(n, curve=P256):
    """Affine (i+1)*G for i < n: oracle Jacobian adds, one batched inversion."""
    p = curve.p
    jacs = [(curve.gx, curve.gy, 1)]
    if n > 1:
        jacs.append(ow._jac_dbl(jacs[0], curve))
    for _ in range(n - 2):
        jacs.append(ow._jac_add(jacs[-1], jacs[0], curve))
    zinv = comb._batch_inv([z for _, _, z in jacs], p)
    return [(x * zi * zi % p, y * zi * zi * zi % p) for (x, y, _), zi in zip(jacs, zinv)]


def varbase_points(n, device, curve=P256):
    """Affine planes: lanes < ORACLE_LANES carry (i+1)G, the rest G."""
    pts = multiples_of_g(ORACLE_LANES, curve)
    g = api.generator_batch(curve, n, device)
    xs, ys = g.x.clone(), g.y.clone()
    d = curve.field.ndigits
    xs[:, :ORACLE_LANES] = torch.from_numpy(convert.ints_to_planes([x for x, _ in pts], d))
    ys[:, :ORACLE_LANES] = torch.from_numpy(convert.ints_to_planes([y for _, y in pts], d))
    return AffinePoint(xs, ys, curve)


def affine_ints(pt, lanes):
    x = convert.planes_to_ints(pt.x[:, :lanes].cpu().numpy())
    y = convert.planes_to_ints(pt.y[:, :lanes].cpu().numpy())
    return list(zip(x, y))


def jacobian_affine_ints(planes, lanes, curve=P256):
    """Jacobian (x, y, z) planes -> affine int pairs via the plain to_affine."""
    jac = JacobianPoint(*(GFp(t[:, :lanes].contiguous(), curve.field) for t in planes), curve)
    return affine_ints(jac.to_affine(), lanes)


def oracle_mult(k, pt, curve=P256):
    """k * pt (affine ints) for any k: infinity as (0, 0), (n-1) pt = -pt
    (outside the ladder oracle's domain)."""
    k %= curve.order
    x, y = pt
    if k == 0:
        return (0, 0)
    if k == curve.order - 1:
        return (x, (curve.p - y) % curve.p)
    return coz.scalar_mult_affine(k, x, y, curve)


def oracle_base(ks, curve=P256):
    return pmap(oracle_mult, [(k, (curve.gx, curve.gy), curve) for k in ks])


def oracle_varbase(ks, curve=P256):
    """k_i * (i+1) * G, the points of varbase_points."""
    return oracle_base([k * (i + 1) % curve.order for i, k in enumerate(ks)], curve)


def window_degenerate(k, i, curve=P256):
    """True where the plain window's formulas degenerate for k * (i+1)G
    (the window oracle raises), as bench.py's _window_degenerate."""
    x, y = multiples_of_g(ORACLE_LANES, curve)[i]
    try:
        ow.scalar_mult(k, (x, y, 1), curve)
        return False
    except ZeroDivisionError:
        return True


def window_degenerate_lanes(ks, curve=P256):
    """The lanes i of ``ks`` where the plain window degenerates for
    k_i * (i+1)G."""
    flags = pmap(window_degenerate, [(k, i, curve) for i, k in enumerate(ks)])
    return [i for i, f in enumerate(flags) if f]


def _jac_mult(k, pt, curve):
    """Double-and-add on Jacobian ints, None for infinity (k >= 0)."""
    acc, base = None, pt
    while k:
        if k & 1:
            acc = base if acc is None else ow._jac_add(acc, base, curve)
        k >>= 1
        if k:
            base = ow._jac_dbl(base, curve)
    return acc


def oracle_verify(z, r, s, qx, qy, curve):
    """ECDSA verification with Python ints (FIPS 186-5): ranges, Q on the
    curve, R = u1 G + u2 Q by double-and-add, R.x == r mod n."""
    n, p = curve.order, curve.p
    if not (1 <= r < n and 1 <= s < n):
        return 0
    if (qy * qy - qx**3 - curve.a * qx - curve.b) % p:
        return 0
    w = pow(s, -1, n)
    u1, u2 = z % n * w % n, r * w % n
    acc = _jac_mult(u1, (curve.gx, curve.gy, 1), curve)
    s2 = _jac_mult(u2, (qx, qy, 1), curve)
    if acc is None:
        acc = s2
    elif s2 is not None:
        same_x = acc[0] * s2[2] ** 2 % p == s2[0] * acc[2] ** 2 % p
        if same_x and acc[1] * s2[2] ** 3 % p == s2[1] * acc[2] ** 3 % p:
            acc = ow._jac_dbl(acc, curve)
        elif same_x:
            acc = None
        else:
            acc = ow._jac_add(acc, s2, curve)
    if acc is None or acc[2] % p == 0:
        return 0
    return int(acc[0] * pow(acc[2] * acc[2], -1, p) % p % n == r)


def oracle_sign(z, d, k, curve):
    n = curve.order
    r = coz.scalar_mult_affine(k, curve.gx, curve.gy, curve)[0] % n
    return r, pow(k, -1, n) * (z % n + r * d) % n


def infinity_lanes(n, threads, group):
    """Lanes of an ``n``-lane batch that kernel D's checks set to infinity
    (z = 0), in its last two blocks of ``threads`` x ``group`` lanes, away
    from the first lanes the oracle reads; thread t of a block takes lanes
    base + t + j threads, j < group. In the last block: thread 0's first
    and last lanes, thread 33's lanes j = 1 and 2 (two in one group),
    thread threads - 1's last lane (the batch's last lane); in the block
    before: every lane of thread 7's group (a whole group), and the first
    lanes of threads 31 and 32 (a warp's edge)."""
    block = threads * group
    last, prev = n - block, n - 2 * block
    lanes = {last, last + (group - 1) * threads, last + 33 + threads, last + 33 + 2 * threads,
             n - 1, prev + 31, prev + 32}
    lanes |= {prev + 7 + j * threads for j in range(group)}
    return sorted(lanes)


def affine_edge_input(jac, curve):
    """Kernel D's check input: copies of the Jacobian planes ``jac`` with
    ``infinity_lanes`` at z = 0 (the kernel's layout on ``curve`` read from
    the library)."""
    jx, jy, jz = (t.clone() for t in jac)
    threads, group, _ = affine.layout(curve, jz.shape[1])
    jz[:, infinity_lanes(jz.shape[1], threads, group)] = 0
    return jx, jy, jz


def affine_edge_check(got, jac, curve, what):
    """The infinity lanes of kernel D's output ``got`` are (0, 0), and a
    ragged batch (the first n - 333 lanes, no multiple of a block's lanes)
    gives the full run's lanes."""
    n = jac[2].shape[1]
    threads, group, _ = affine.layout(curve, n)
    lanes = infinity_lanes(n, threads, group)
    check(not any(bool(g[:, lanes].any()) for g in got), f"{what}: infinity lanes -> (0, 0)")
    cut = n - 333
    ragged = affine.affine_planes(*(t[:, :cut].contiguous() for t in jac), curve)
    check(max_abs_diff(ragged, [g[:, :cut] for g in got]) == 0,
          f"{what}: a ragged batch of {cut} lanes == the full run's lanes")


def affine_large_check(jac, curve, what):
    """Kernel D on a batch that runs the curve's own lanes a thread (the
    main path's; the CHECK_LANES checks run the small batch's): the
    Jacobian planes ``jac`` with ``infinity_lanes`` at z = 0, its last two
    blocks against JacobianPoint.to_affine on those lanes, the infinity
    lanes (0, 0) and a ragged batch."""
    jx, jy, jz = affine_edge_input(jac, curve)
    got = affine.affine_planes(jx, jy, jz, curve)
    n = jz.shape[1]
    threads, group, _ = affine.layout(curve, n)
    lo = n - 2 * threads * group
    plain = JacobianPoint(*(GFp(t[:, lo:].contiguous(), curve.field) for t in (jx, jy, jz)),
                          curve).to_affine()
    check(max_abs_diff([g[:, lo:] for g in got], (plain.x, plain.y)) == 0,
          f"{what} at {group} lanes a thread: its last two blocks == JacobianPoint.to_affine")
    affine_edge_check(got, (jx, jy, jz), curve, f"{what} at {group} lanes a thread")


def max_abs_diff(xs, ys):
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(xs, ys))


def time_ms(fn, iters):
    """Mean milliseconds per call over ``iters`` calls after one warm-up,
    measured with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_once_ms(fn):
    """Milliseconds of one call, CUDA events, no warm-up (for slow plain runs)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def resource_report(log):
    """Registers, spills, stack frame and shared memory per kernel (by its
    name in the JSON line) from nvcc's -Xptxas -v output."""
    rep = sass.ptxas(log)
    found = {k: sass.resources(rep, part) for k, part in PTXAS_NAMES.items()}
    return {k: v for k, v in found.items() if v is not None}


def bound(name, lanes, sm_clock_mhz, reps=0):
    """(bound_ms, bound_by) for ``lanes`` lanes of kernel ``name``. The
    calibration kernel I (``lanes`` elements, ``reps`` chain steps) is
    charged its issued instructions: a chain step's 5 operations compile to
    4 (IMAD and IMAD.IADD on the multiply-add pipe, LOP3 and LEA.HI on the
    ALU pipe: the shift and its add fuse; cuobjdump -sass of csrc/calib.cu
    on sm_90a), and the two pipes issue side by side at 64 lanes per SM per
    clock each."""
    if name.startswith("batch_sum"):
        return batch_sum_bound(name, lanes, sm_clock_mhz)
    if name == "calib":
        ops = CALIB_PIPE_INSTRS_PER_STEP * roofline.CHAINS * reps * lanes / 2  # per pipe
    else:
        muls, sqrs = LANE_MS[name]
        extra = FOLD_IMADS if name in FOLD_FIELD else 0
        per_mul, per_sqr = WIDE_IMADS.get(name.rpartition("_")[2], (IMADS_PER_MUL, IMADS_PER_SQR))
        ops = (muls * (per_mul + extra) + sqrs * (per_sqr + extra)
               + SMALL_IMADS.get(name, 0)) * lanes
        once_m, once_s = ONCE_MS.get(name, (0, 0))
        ops += once_m * (per_mul + extra) + once_s * (per_sqr + extra)
    tag = name.rpartition("_")[2]
    table = (BYTES_PER_LANE[f"comb_table_{tag}"] if tag in WIDE_IMADS else COMB_TABLE_BYTES)
    nbytes = BYTES_PER_LANE[name] * lanes + (table if name.startswith("comb") else 0)
    op_ms = ops / (IMAD_PER_SM_PER_CLOCK * SMS * sm_clock_mhz * 1e6) * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def batch_sum_bound(name, lanes, sm_clock_mhz):
    """(bound_ms, bound_by) of kernel M over a whole tree of ``lanes``
    lanes: lanes - 1 complete adds (jac_add and the curve's doubling, both
    always computed: FORMULA_MS's add_complete of the curve), and the bytes
    the function must move: the batch's lanes read once and the one output
    lane written once, three planes of D digits each. The levels' own
    outputs, which the next level reads back, are this design's
    intermediates, not the function's traffic."""
    tag = name[len("batch_sum_"):] or "p256"
    curve = next(c for c, (t, _) in _build.CURVE_TAGS.items() if t == tag)
    if tag in WIDE_IMADS:
        (per_mul, per_sqr), extra = WIDE_IMADS[tag], 0
        muls, sqrs = FORMULA_MS["add_complete"]
    else:
        per_mul, per_sqr = IMADS_PER_MUL, IMADS_PER_SQR
        extra = FOLD_IMADS if tag in CURVES18.values() else 0
        muls, sqrs = FORMULA_MS[CURVE_FORMULAS[tag][1]]
    ops = (lanes - 1) * (muls * (per_mul + extra) + sqrs * (per_sqr + extra))
    nbytes = (lanes + 1) * 3 * curve.field.ndigits * 4
    op_ms = ops / (IMAD_PER_SM_PER_CLOCK * SMS * sm_clock_mhz * 1e6) * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def nvidia_smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# RFC 7748 §5.2: (scalar, u, X25519(scalar, u)) as hex, and iteration 1
# (k = u = 9, one step of the iteration test)
RFC7748 = [
    ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
     "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
     "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
     "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
     "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
    ("09" + "00" * 31, "09" + "00" * 31,
     "422c8e7a6227d7bca1350b3e2bb7279f7897b87bb6854b783c60e80311ae3079"),
]
P25519 = W25519_FIELD.p
CALIB_CHECK_REPS = 16  # kernel I against calib_plain
CALIB_PIPE_INSTRS_PER_STEP = 4  # kernel I's chain step as compiled: 2 multiply-add + 2 ALU
CALIB_REPS = 1 << 18  # the ceiling measurement: ~10^2 ms a launch on one H100


def x25519_int(k, u):
    """RFC 7748 §5 X25519 on Python ints: clamped k, any u (reduced mod p),
    the output u; 0 for a low-order u."""
    p = P25519
    u %= p
    x2, z2, x3, z3, swap = 1, 0, u, 1, 0
    for t in range(254, -1, -1):
        kt = (k >> t) & 1
        if swap ^ kt:
            x2, x3, z2, z3 = x3, x2, z3, z2
        swap = kt
        a, b, c, d = (x2 + z2) % p, (x2 - z2) % p, (x3 + z3) % p, (x3 - z3) % p
        aa, bb, da, cb = a * a % p, b * b % p, d * a % p, c * b % p
        e = (aa - bb) % p
        x3, z3 = (da + cb) ** 2 % p, u * (da - cb) ** 2 % p
        x2, z2 = aa * bb % p, e * (aa + x25519.A24 * e) % p
    if swap:
        x2, z2 = x3, z3
    return x2 * pow(z2, p - 2, p) % p


def twist_u():
    """The least u > 1 on the quadratic twist of Curve25519: u^3 + A u^2 + u
    is not a square mod p."""
    p, u = P25519, 2
    while pow((u * u * u + x25519.MONT_A * u * u + u) % p, (p - 1) // 2, p) != p - 1:
        u += 1
    return u


def split32(raw):
    return [raw[i:i + 32] for i in range(0, len(raw), 32)]


def x25519_phases(rng, dev, card, counted):
    """Phases 13-16: the 2^255 - 19 field, the X25519 kernels, the fourth
    main path and the calibration. Returns the numbers of the kernels line."""
    fs, pw = W25519_FIELD, P25519
    le = lambda v: v.to_bytes(32, "little")  # noqa: E731
    out = {}

    # -- phase 13: the 2^255 - 19 field (kernel C on the Crandall fold) --------------
    a = random_planes(rng, CHECK_LANES)
    b = random_planes(rng, CHECK_LANES)
    edges = [0, 1, 2, pw - 1, pw - 2, pw - 19, 1 << 254, (1 << 255) - (1 << 32)]
    pairs = [(x, y) for x in edges for y in edges]
    a[:, : len(pairs)] = convert.ints_to_planes([x for x, _ in pairs], D)
    b[:, : len(pairs)] = convert.ints_to_planes([y for _, y in pairs], D)
    a_dev, b_dev = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    got = field_ops.probe(a_dev, b_dev, fs)
    out["probe_err"] = max_abs_diff(got, field_ops.probe_plain(a_dev, b_dev, fs))
    check(out["probe_err"] == 0, "w25519 field probe == plain GFp (Crandall)")
    ai, bi = convert.planes_to_ints(a[:, :64]), convert.planes_to_ints(b[:, :64])
    ints = [convert.planes_to_ints(got[k, :, :64].cpu().numpy()) for k in range(5)]
    check(ints[0] == [x * y % pw for x, y in zip(ai, bi)], "w25519 probe mul vs ints")
    check(ints[1] == [x * x % pw for x in ai], "w25519 probe sqr vs ints")
    check(ints[2] == [(x + y) % pw for x, y in zip(ai, bi)], "w25519 probe add vs ints")
    check(ints[3] == [(x - y) % pw for x, y in zip(ai, bi)], "w25519 probe sub vs ints")
    check(ints[4] == [(-x) % pw for x in ai], "w25519 probe opposite vs ints")
    out["probe_ms"] = time_ms(lambda: field_ops.probe(a_dev, b_dev, fs), 20)
    out["probe_plain_ms"] = time_ms(lambda: field_ops.probe_plain(a_dev, b_dev, fs), 3)
    say(f"phase 13 w25519 field probe: {CHECK_LANES} lanes exact vs plain GFp (edge pairs of "
          f"0, 1, 2, p-1, p-2, p-19, 2^254, 2^255-2^32) and 64 vs ints; kernel "
          f"{out['probe_ms']:.3f} ms, plain {out['probe_plain_ms']:.3f} ms {card}")

    # -- phase 14: kernels G, H, B, D on 2^255 - 19 / Wei25519 ----------------------
    k_bytes = split32(rng.bytes(32 * CHECK_LANES))
    k14 = x25519._byte_planes(k_bytes, True, dev)
    k_ints = convert.planes_to_ints(k14[:, :ORACLE_LANES].cpu().numpy())
    u14_np = random_planes(rng, CHECK_LANES)
    u14_np[:, :4] = convert.ints_to_planes([0, 1, pw - 1, 9], D)
    u14 = torch.from_numpy(u14_np).to(dev)
    x2, z2 = mladder.mladder_planes(k14, u14, fs, x25519.A24, 255)
    px, pz = mladder.mladder_plain(k14, u14, fs, x25519.A24, 255)
    out["mladder_check_err"] = max_abs_diff((x2, z2), (px, pz))
    check(out["mladder_check_err"] == 0, "mladder kernel == mladder_plain (x2, z2)")
    del px, pz
    h = mladder.xdivz(x2, z2)
    out["xdivz_check_err"] = max_abs_diff([h], [mladder.xdivz_plain(x2, z2, fs)])
    check(out["xdivz_check_err"] == 0, "xdivz kernel == plain batch-inverse x / z")
    u_ints = convert.planes_to_ints(u14_np[:, :ORACLE_LANES])
    want = pmap(x25519_int, list(zip(k_ints, u_ints)))
    check(convert.planes_to_ints(h[:, :ORACLE_LANES].cpu().numpy()) == want,
          "mladder + xdivz vs the RFC 7748 int ladder")
    check(want[:2] == [0, 0], "u = 0 and u = 1 give 0")
    rfc = x25519.x25519_batch([bytes.fromhex(k) for k, _, _ in RFC7748],
                              [bytes.fromhex(u) for _, u, _ in RFC7748])
    check([r.hex() for r in rfc] == [o for _, _, o in RFC7748],
          "RFC 7748 §5.2 vectors, iteration 1")

    tables_w, negbase_w, nb_w = comb.device_tables(WEI25519, WEI25519.gx, WEI25519.gy, dev)
    mma_w = comb.mma_tables(WEI25519, WEI25519.gx, WEI25519.gy, dev)
    jac = comb.comb_planes(k14, mma_w, nb_w, WEI25519)
    out["comb_check_err"] = max_abs_diff(jac, comb.comb_plain(k14, tables_w, WEI25519, negbase_w))
    check(out["comb_check_err"] == 0, "Wei25519 comb kernel == comb_plain (Jacobian)")
    jx, jy, jz = affine_edge_input(jac, WEI25519)
    got = affine.affine_planes(jx, jy, jz, WEI25519)
    plain = JacobianPoint(*(GFp(t, fs) for t in (jx, jy, jz)), WEI25519).to_affine()
    out["affine_check_err"] = max_abs_diff(got, (plain.x, plain.y))
    check(out["affine_check_err"] == 0, "Wei25519 affine kernel == JacobianPoint.to_affine")
    affine_edge_check(got, (jx, jy, jz), WEI25519, "Wei25519 affine")
    xs = convert.planes_to_ints(got[0][:, :ORACLE_LANES].cpu().numpy())
    check([(x - x25519.A_OVER_3) % pw for x in xs] == [x25519_int(k, 9) for k in k_ints],
          "comb + affine keys vs the int ladder X25519(k, 9)")
    del x2, z2, h, jac, jx, jy, jz, got, plain
    say(f"phase 14 X25519 kernels: G (x-only ladder) and H (x / z) {CHECK_LANES} lanes exact vs "
          f"mladder_plain / batch-inverse x / z, {ORACLE_LANES} lanes vs the int ladder (u = 0, 1, "
          f"p-1, 9 first); RFC 7748 §5.2 vectors and iteration 1; Wei25519 comb (B) and affine "
          f"(D) {CHECK_LANES} lanes exact vs comb_plain / to_affine (lanes at infinity at group "
          f"edges; a ragged batch), "
          f"{ORACLE_LANES} keys vs the int ladder")

    # -- phase 15: the fourth main path, batched X25519 at B = 524,288 --------------
    ka = split32(rng.bytes(32 * BATCH))
    kb = split32(rng.bytes(32 * BATCH))
    sp = ORACLE_LANES - 8  # lanes sp..sp+5: special peer u's, inside the checked lanes
    zero_counts(counted)
    qa = x25519.derive_public_batch(ka)
    qb = x25519.derive_public_batch(kb)
    top_set = bytearray(qb[sp + 4])
    top_set[31] |= 0x80  # masked: the same peer as qb[sp + 4]
    special = [le(0), le(1), le(pw), le(pw + 1), bytes(top_set), le(twist_u())]
    peers = qb[:sp] + special + qb[sp + 6:]
    s_ab = x25519.x25519_batch(ka, peers)
    s_ba = x25519.x25519_batch(kb, qa)
    torch.cuda.synchronize()
    launches15 = read_counts(counted)
    for k in (comb.KERNEL_W25519, affine.KERNEL_W25519, mladder.KERNEL, mladder.KERNEL_XDIVZ):
        check(launches15[k.symbol] >= 1, f"X25519 path launched {k.symbol}")
    check(len(s_ab) == len(s_ba) == len(qa) == BATCH and all(len(v) == 32 for v in s_ab),
          "output shape: 524,288 32-byte strings")
    check(all(int.from_bytes(v, "little") < pw for v in (*s_ab[:ORACLE_LANES], *qa[:ORACLE_LANES])),
          "outputs canonical")
    low = set(range(sp, sp + 4)) | {sp + 5}  # u = 0, 1, p, p + 1 and the twist lane
    diff = [i for i in range(BATCH) if s_ab[i] != s_ba[i]]
    check(diff == [sp, sp + 1, sp + 2, sp + 3, sp + 5],
          f"k_a * Q_b == k_b * Q_a on every lane but the special peers (differ: {diff[:8]})")
    ca = [x25519.clamp(k) for k in ka[:ORACLE_LANES]]
    check([int.from_bytes(q, "little") for q in qa[:ORACLE_LANES]]
          == [x25519_int(k, 9) for k in ca], "derive_public_batch vs the int ladder")
    want = pmap(x25519_int, [(k, x25519.decode_u(u)) for k, u in zip(ca, peers[:ORACLE_LANES])])
    check([int.from_bytes(v, "little") for v in s_ab[:ORACLE_LANES]] == want,
          "x25519_batch vs the int ladder, special lanes included")
    check([s_ab[i] for i in sorted(low - {sp + 5})] == [bytes(32)] * 4, "u = 0, 1, p, p + 1 give 0")
    check(s_ab[sp + 5] != bytes(32) and s_ab[sp + 4] == s_ba[sp + 4], "twist and masked-bit lanes")

    # the kernels against their plain versions on the path's own inputs (these
    # launches come after the counts were read)
    kpa = x25519._byte_planes(ka, True, dev)
    upb = x25519.reduce_u(x25519._byte_planes(peers, False, dev))
    x2, z2 = mladder.mladder_planes(kpa, upb, fs, x25519.A24, 255)
    out["mladder_plain_ms"], plain = time_once_ms(
        lambda: mladder.mladder_plain(kpa, upb, fs, x25519.A24, 255))
    out["mladder_err"] = max_abs_diff((x2, z2), plain)
    check(out["mladder_err"] == 0, "mladder kernel == mladder_plain at B = 524,288")
    del plain
    out["xdivz_plain_ms"], plain = time_once_ms(lambda: mladder.xdivz_plain(x2, z2, fs))
    out["xdivz_err"] = max_abs_diff([mladder.xdivz(x2, z2)], [plain])
    check(out["xdivz_err"] == 0, "xdivz kernel == batch-inverse x / z at B = 524,288")
    jac = comb.comb_planes(kpa, mma_w, nb_w, WEI25519)
    out["comb_plain_ms"], plain = time_once_ms(
        lambda: comb.comb_plain(kpa, tables_w, WEI25519, negbase_w))
    out["comb_err"] = max_abs_diff(jac, plain)
    check(out["comb_err"] == 0, "Wei25519 comb kernel == comb_plain at B = 524,288")
    out["affine_plain_ms"], plain = time_once_ms(
        lambda: JacobianPoint(*(GFp(t, fs) for t in jac), WEI25519).to_affine())
    out["affine_err"] = max_abs_diff(affine.affine_planes(*jac, WEI25519), (plain.x, plain.y))
    check(out["affine_err"] == 0, "Wei25519 affine kernel == to_affine at B = 524,288")
    affine_large_check(jac, WEI25519, "Wei25519 affine")
    del plain
    out["mladder_ms"] = time_ms(lambda: mladder.mladder_planes(kpa, upb, fs, x25519.A24, 255), 5)
    out["xdivz_ms"] = time_ms(lambda: mladder.xdivz(x2, z2), 10)
    out["comb_ms"] = time_ms(lambda: comb.comb_planes(kpa, mma_w, nb_w, WEI25519), 10)
    out["affine_ms"] = time_ms(lambda: affine.affine_planes(*jac, WEI25519), 10)
    upb_raw = x25519._byte_planes(peers, False, dev)
    out["x25519_planes_ms"] = time_ms(lambda: x25519.x25519_planes(kpa, upb_raw), 5)
    out["derive_public_planes_ms"] = time_ms(lambda: x25519.derive_public_planes(kpa), 10)
    out["launches15"] = launches15
    rate = BATCH / (out["x25519_planes_ms"] / 1e3)
    say(f"phase 15 X25519 main path B={BATCH}: launches {json.dumps(launches15)}; "
          f"derive_public_batch and x25519_batch both ways equal on every lane but the special "
          f"peers (u = 0, 1, p, p+1 give 0; twist and masked-bit lanes right), {ORACLE_LANES} "
          f"lanes vs the int ladder; G, H, B, D exact vs their plain versions; mladder kernel "
          f"{out['mladder_ms']:.3f} ms, plain {out['mladder_plain_ms']:.1f} ms; xdivz "
          f"{out['xdivz_ms']:.3f} ms, plain {out['xdivz_plain_ms']:.1f} ms; comb "
          f"{out['comb_ms']:.3f} ms, plain {out['comb_plain_ms']:.1f} ms; affine "
          f"{out['affine_ms']:.3f} ms, plain {out['affine_plain_ms']:.1f} ms; "
          f"x25519.x25519_planes {out['x25519_planes_ms']:.3f} ms ({rate:.0f} exchanges/s), "
          f"x25519.derive_public_planes {out['derive_public_planes_ms']:.3f} ms {card}")
    del x2, z2, jac, kpa, upb, upb_raw

    # -- phase 16: the calibration (kernel I) --------------------------------------
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = sms * roofline.THREADS_PER_SM
    ca_dev, cb_dev = (torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=n, dtype=np.int64)
                                       .astype(np.int32)).to(dev) for _ in range(2))
    got = roofline.calib(ca_dev, cb_dev, CALIB_CHECK_REPS)
    out["calib_plain_ms"], plain = time_once_ms(
        lambda: roofline.calib_plain(ca_dev, cb_dev, CALIB_CHECK_REPS))
    out["calib_err"] = max_abs_diff([got], [plain])
    check(out["calib_err"] == 0, "calib kernel == calib_plain")
    zero_counts(counted)
    ceiling = roofline.measure_int32_ceiling(reps=CALIB_REPS, iters=8, device=dev)
    out["launches16"] = read_counts(counted)
    check(out["launches16"][roofline.KERNEL.symbol] >= 1, "calibration launched ec_calib")
    out["ceiling"] = ceiling
    out["calib_elements"] = n
    say(f"phase 16 calibration: kernel I exact vs calib_plain ({n} elements, "
          f"{CALIB_CHECK_REPS} reps; plain {out['calib_plain_ms']:.1f} ms); measure_int32_ceiling "
          f"({CALIB_REPS} reps, {n} elements): {ceiling['int32_ops_per_s']:.4e} int32 ops/s, "
          f"{ceiling['imad_per_s']:.4e} IMAD/s, {ceiling['ms_per_launch']:.3f} ms a launch {card}")
    return out


def schedule_args(kname):
    """The entry point's keyword arguments of a phase 17 schedule (its JSON
    name) or the arguments themselves, as text."""
    kw = SCHEDULES[kname] if isinstance(kname, str) else kname
    return ", ".join(f"{a}={b!r}" for a, b in kw.items())


def comb_degenerate(k, tables_np, negbase, kw, curve=P256):
    """True where the composition of the schedule ``kw`` on Python ints
    (oracle.comb, on classical tables) hits a degenerate add (equal or
    opposite x): the tree's subset sums, the chains' prefix sums and their
    cross-chain sums, the fix-up; any number of chains, ``unroll`` changing
    nothing. A strict schedule (complete adds) has none. Such lanes leave
    the oracle check only; kernel and plain version agree on them bit for
    bit all the same."""
    if kw.get("strict"):
        return False
    try:
        if kw.get("chain") == "tree":
            ocomb.tree(k, tables_np, negbase, curve)
        else:
            ocomb.chains(k, tables_np, negbase, curve, kw.get("chains", 1))
    except ZeroDivisionError:
        return True
    return False


def schedule_phase(rng, dev, card, counted, scalars, b_plain_ms):
    """Phase 17: the comb's other schedules on P-256 — kernels J (tree), K
    (pipe) and L (chains / unroll, SCHEDULES_L) — against their plain
    versions (K: kernel B), the oracle, and on the path that bench.py times
    under BENCH_CHAIN / BENCH_UNROLL: comb.scalar_mult_base(chain, chains,
    unroll) then kernel D, at B = 524,288 on phase 6's scalars.
    ``b_plain_ms``: comb_plain's time on those scalars (phase 6), K's plain
    version. Returns the numbers of the kernels line."""
    tables, negbase, nb = comb.device_tables(P256, P256.gx, P256.gy, dev)
    mma = comb.mma_tables(P256, P256.gx, P256.gy, dev)
    tables_np, negbase_ints = comb.base_tables(P256, P256.gx, P256.gy)
    kernels = {k: schedule_kernel(P256, kw) for k, kw in SCHEDULES.items()}

    def run(kw, s):
        return comb.schedule_planes(s, mma, nb, P256, **kw)

    def reference(kw, s):
        """The plain version (J, L) or kernel B (K) on the same inputs."""
        if kw.get("chain") == "tree":
            return comb.comb_tree_plain(s, tables, P256, negbase)
        if kw.get("chain") == "pipe":
            return comb.comb_planes(s, mma, nb)
        return comb.comb_chains_plain(s, tables, P256, negbase, kw["chains"], kw["unroll"],
                                      kw["strict"])

    out = {k: {} for k in SCHEDULES}
    # -- 65,536 lanes against the plain versions / kernel B, 512 against the oracle
    sets = {}
    for strict in (False, True):
        ks_np = scalar_planes(rng, CHECK_LANES, EDGE_SCALARS + ([N - 1] if strict else []))
        ks = convert.planes_to_ints(ks_np[:, :ORACLE_LANES])
        sets[strict] = (torch.from_numpy(ks_np).to(dev), ks, oracle_base(ks))
    excluded = {}
    for kname, kw in SCHEDULES.items():
        s, ks, want = sets[kw.get("strict", False)]
        got = run(kw, s)
        out[kname]["check_err"] = max_abs_diff(got, reference(kw, s))
        check(out[kname]["check_err"] == 0, f"{kname} kernel == its plain version (K: kernel "
                                             f"B; {CHECK_LANES} lanes)")
        lanes = [i for i, k in enumerate(ks) if kw.get("strict") or not comb_degenerate(
            k, tables_np, negbase_ints, kw)]
        excluded[kname] = ORACLE_LANES - len(lanes)
        aff = affine_ints(AffinePoint(*affine.affine_planes(*got), P256), ORACLE_LANES)
        check([aff[i] for i in lanes] == [want[i] for i in lanes], f"{kname} vs oracle")
    del got, sets
    say(f"phase 17 comb schedules: J (tree), L (chains 2, 4; one chain at unroll 2, 4; "
          f"strict, n-1 included) {CHECK_LANES} lanes exact vs comb_tree_plain / "
          f"comb_chains_plain; K (pipe) exact vs kernel B; {ORACLE_LANES} lanes of each "
          f"through kernel D vs oracle (degenerate lanes excluded: {json.dumps(excluded)})")

    # -- the path: entry point -> kernel J, K or L -> kernel D, at B = 524,288
    ks = convert.planes_to_ints(scalars[:, :MAIN_ORACLE_LANES].cpu().numpy())
    want = oracle_base(ks)
    zero_counts(counted)
    results = {kname: affine.to_affine(comb.scalar_mult_base(scalars, P256, **kw))
               for kname, kw in SCHEDULES.items()}
    torch.cuda.synchronize()
    launches17 = read_counts(counted)
    for kname in SCHEDULES:
        check(launches17[kernels[kname].symbol] >= 1, f"phase 17 path launched {kname}")
    check(launches17[affine.KERNEL.symbol] >= len(SCHEDULES), "phase 17 path launched affine")
    main_excluded = {}
    for kname, res in results.items():
        check(res.x.shape == (D, BATCH) and res.y.shape == (D, BATCH), f"{kname} output shape")
        check(res.x.dtype == torch.int32, f"{kname} output dtype")
        check(bool(((res.x >= 0) & (res.x < 1 << 16)).all()), f"{kname} digits in range")
        kw = SCHEDULES[kname]
        lanes = [i for i, k in enumerate(ks) if kw.get("strict") or not comb_degenerate(
            k, tables_np, negbase_ints, kw)]
        main_excluded[kname] = MAIN_ORACLE_LANES - len(lanes)
        got = affine_ints(res, MAIN_ORACLE_LANES)
        check([got[i] for i in lanes] == [want[i] for i in lanes], f"{kname} path vs oracle")
    del results

    # -- each kernel against its plain version (K: kernel B) on the path's
    # inputs (these launches come after the counts were read)
    for kname, kw in SCHEDULES.items():
        got = run(kw, scalars)
        if kw.get("chain") == "pipe":
            out[kname]["plain_ms"] = b_plain_ms
            want_planes = reference(kw, scalars)
        else:
            out[kname]["plain_ms"], want_planes = time_once_ms(lambda: reference(kw, scalars))
        out[kname]["err"] = max_abs_diff(got, want_planes)
        check(out[kname]["err"] == 0, f"{kname} kernel == its plain version (K: kernel B) at "
                                      f"B = {BATCH}")
        del got, want_planes
    for kname, kw in SCHEDULES.items():
        out[kname]["ms"] = time_ms(lambda: run(kw, scalars), 20)
        if "chains" in kw:  # kernel L: its shared memory at this schedule
            out[kname] |= general_smem(P256, kname, kernels[kname], kw)
        out[kname]["api_ms"] = time_ms(
            lambda: affine.to_affine(comb.scalar_mult_base(scalars, P256, **kw)), 10)
    say(f"phase 17 comb schedules main path B={BATCH} (comb.scalar_mult_base -> kernel, then "
          f"kernel D): launches {json.dumps(launches17)}; {MAIN_ORACLE_LANES} lanes of each vs "
          f"oracle (degenerate lanes excluded: {json.dumps(main_excluded)}); each kernel exact vs "
          f"its plain version (K: kernel B) on the path's inputs; L's staged positions a step "
          f"and shared memory {json.dumps(staged_smem(out))}; kernel ms "
          f"{json.dumps({k: round(v['ms'], 3) for k, v in out.items()})}; entry point + D ms "
          f"{json.dumps({k: round(v['api_ms'], 3) for k, v in out.items()})}; plain ms "
          f"{json.dumps({k: round(v['plain_ms'], 1) for k, v in out.items()})} {card}")
    return {"launches17": launches17, "kernels": kernels, "by_kernel": out}


def schedule_path(dev, card, counted, curve, scalars, ks, phase):
    """The comb's schedules PATH_SCHEDULES[curve] (JSON name -> keyword
    arguments of comb.scalar_mult_base) on ``curve`` at B = 524,288 on
    ``scalars`` (``ks``: at least the first ORACLE_LANES as ints): phase
    17's B9 part and phase 20. Their plain versions (comb_tree_plain, comb_chains_plain,
    comb_plain) on the first CHECK_LANES lanes start in the plain pool;
    the path: each schedule through the entry point, then kernel D, with
    the launch counts reset before and read after; ORACLE_LANES lanes of
    each against the oracle (lanes where the schedule's composition on ints
    degenerates excluded and counted); each kernel exact against its plain
    version on the first CHECK_LANES lanes; kernel L's shared memory equal
    to comb.general_smem_bytes; the times. Returns the numbers of the
    kernels line."""
    fs, d = curve.field, curve.field.ndigits
    schedules = PATH_SCHEDULES[curve]
    mma = comb.mma_tables(curve, curve.gx, curve.gy, dev)
    nb = comb.device_tables(curve, curve.gx, curve.gy, dev)[2]
    tables_np, negbase_ints = comb.base_tables(curve, curve.gx, curve.gy)
    classical = ocomb.classical_tables(tables_np, fs)
    m = CHECK_LANES
    s_c = scalars[:, :m].contiguous()
    host = [s_c.cpu().numpy()]

    def plain_key(kw):
        if kw.get("chain") == "tree":
            return "comb_tree", False, 1
        if kw.get("chains", 1) > 1:
            return "comb_chains", False, kw["chains"]
        return "comb", kw.get("strict", False), 1

    jobs = {}
    for kw in schedules.values():
        key = plain_key(kw)
        if key not in jobs:
            jobs[key] = plain_submit(key[0], curve, key[1], host, dev.type, key[2])

    # -- the path
    zero_counts(counted)
    results = {name: affine.to_affine(comb.scalar_mult_base(scalars, curve, **kw))
               for name, kw in schedules.items()}
    torch.cuda.synchronize()
    launches = read_counts(counted)
    kernels = {tagged(curve, name): schedule_kernel(curve, kw) for name, kw in schedules.items()}
    for name, kernel in kernels.items():
        check(launches[kernel.symbol] >= 1, f"phase {phase} path on {curve.name} launched {name}")
    check(launches[affine.KERNELS[curve].symbol] >= len(schedules),
          f"phase {phase} path on {curve.name} launched affine")

    # -- ORACLE_LANES lanes of each result against the oracle
    want = oracle_base(ks[:ORACLE_LANES], curve)
    excluded = {}
    for name, kw in schedules.items():
        res = results[name]
        check(res.x.shape == (d, BATCH) and res.x.dtype == torch.int32, f"{name} output shape")
        check(bool(((res.x >= 0) & (res.x < 1 << 16)).all()), f"{name} digits in range")
        flags = pmap(comb_degenerate, [(k, classical, negbase_ints, kw, curve)
                                       for k in ks[:ORACLE_LANES]])
        lanes = [i for i, f in enumerate(flags) if not f]
        excluded[name] = ORACLE_LANES - len(lanes)
        got = affine_ints(res, ORACLE_LANES)
        check([got[i] for i in lanes] == [want[i] for i in lanes],
              f"phase {phase} {curve.name} {name} vs oracle")
    del results
    say(f"phase {phase} {curve.name} comb schedules path B={BATCH} (comb.scalar_mult_base -> "
        f"kernel, then kernel D): launches {json.dumps({k: v for k, v in launches.items() if v})}; "
        f"{ORACLE_LANES} lanes of each "
        f"vs oracle (edge scalars first; degenerate lanes excluded: {json.dumps(excluded)})")

    # -- each kernel against its plain version on the first CHECK_LANES lanes
    # (these launches come after the counts were read), kernel L's shared
    # memory, and the times at full width
    out = {}
    for name, kw in schedules.items():
        want_np, plain_ms = jobs[plain_key(kw)].result()
        got = comb.schedule_planes(s_c, mma, nb, curve, **kw)
        err = max_abs_diff(got, [torch.from_numpy(w).to(dev) for w in want_np])
        check(err == 0, f"{curve.name} {name} kernel == its plain version on {m} lanes")
        row = {"err": err, "plain_ms": plain_ms, "plain_lanes": m, "schedule": kw}
        kernel = kernels[tagged(curve, name)]
        if kernel is comb.KERNELS_GENERAL[(curve, kw.get("strict", False))]:
            row |= general_smem(curve, name, kernel, kw)
        out[tagged(curve, name)] = row
    del got
    wide = curve in CURVES19
    api_ms = {}
    for name, kw in schedules.items():
        out[tagged(curve, name)]["ms"] = time_ms(
            lambda kw=kw: comb.schedule_planes(scalars, mma, nb, curve, **kw),
            10 if wide else 20)
        api_ms[f"{curve.name} comb.scalar_mult_base({schedule_args(kw)}) + affine"] = time_ms(
            lambda kw=kw: affine.to_affine(comb.scalar_mult_base(scalars, curve, **kw)),
            5 if wide else 10)
    say(f"phase {phase} {curve.name} comb schedules: each kernel exact vs its plain version "
        f"(comb_tree_plain, comb_chains_plain, comb_plain) on the path's first {m} lanes; "
        f"L's staged positions a step and shared memory {json.dumps(staged_smem(out))}; "
        f"kernel ms at B={BATCH} {json.dumps({k: round(v['ms'], 3) for k, v in out.items()})}; "
        f"entry point + D ms {json.dumps({k: round(v, 3) for k, v in api_ms.items()})}; plain ms "
        f"at {m} lanes {json.dumps({k: round(v['plain_ms'], 1) for k, v in out.items()})} {card}")
    return {"launches": launches, "kernels": kernels, "by_kernel": out, "api_ms": api_ms}


def general_phase(rng, dev, card, counted, scalars):
    """Phase 17, its B9 part: kernel L at PATH_SCHEDULES[curve] —
    SCHEDULES_B9 on P-256 (on phase 6's 524,288 scalars), B9_OTHER on
    secp256k1 and Wei25519 (edge scalars 1, 2, 5, n-2, n-1 first) — each a
    path of its own (schedule_path). Returns {curve: schedule_path's
    numbers}."""
    ks = convert.planes_to_ints(scalars[:, :ORACLE_LANES].cpu().numpy())
    out = {P256: schedule_path(dev, card, counted, P256, scalars, ks, "17 (B9)")}
    for curve in CURVES18:
        n = curve.order
        ks_c = scalar_ints(rng, BATCH, [1, 2, 5, n - 2, n - 1], curve)
        out[curve] = schedule_path(dev, card, counted, curve, to_dev(ks_c, dev), ks_c, "17 (B9)")
    return out


def wide_schedule_phase(rng, dev, card, counted, curve):
    """Phase 20 on ``curve`` (P-384 or P-521): the comb's schedules of
    PATH_SCHEDULES[curve] — kernels J, K and L — through the
    entry point and kernel D at B = 524,288 (schedule_path; edge scalars 1,
    2, 5, n-2, n-1 first); first, on P-521, the schedules of WIDE_REFUSED
    refused by check_schedule (ValueError), as the JAX package refuses
    them."""
    n, d = curve.order, curve.field.ndigits
    ks = scalar_ints(rng, BATCH, [1, 2, 5, n - 2, n - 1], curve)
    scalars = to_dev(ks, dev, d)
    for kw in WIDE_REFUSED.get(curve, ()):
        try:
            comb.scalar_mult_base(scalars, curve, **kw)
        except ValueError:
            continue
        check(False, f"{curve.name}: comb.scalar_mult_base({schedule_args(kw)}) refused")
    if curve in WIDE_REFUSED:
        say(f"phase 20 {curve.name}: comb.scalar_mult_base refuses "
            f"{[schedule_args(kw) for kw in WIDE_REFUSED[curve]]} (ValueError: npos "
            f"{curve.field.nbits // comb.W} not a multiple of chains * unroll)")
    return schedule_path(dev, card, counted, curve, scalars, ks, 20)


def ecdh_path(rng, dev, card, curve=WEI25519, phase=18):
    """The protocol path of phase 18 (Wei25519) and 19 (P-384, P-521),
    inside its launch count: ECDH (two parties' keys, then shared secrets
    both ways with a zero scalar, scalar = n, an off-curve peer and x = p in
    the batch) and api.scalar_mult_base(strict=True) with k = n - 1 on lane
    4. Returns its calls to time, {name: (call, repetitions)}: the caller
    times them when the plain versions no longer share the card."""
    n, p, d = curve.order, curve.p, curve.field.ndigits
    name = curve.name
    d1 = scalar_ints(rng, BATCH, [1, 2, 5, n - 2], curve)
    d2 = scalar_ints(rng, BATCH, [3, n - 2], curve)
    bad = BATCH - 4  # lanes bad..bad+3
    d1[bad], d1[bad + 1] = 0, n
    d1_dev, d2_dev = to_dev(d1, dev, d), to_dev(d2, dev, d)
    q1x, q1y, ok1 = ecdh.derive_public_planes(d1_dev, curve)
    q2x, q2y, ok2 = ecdh.derive_public_planes(d2_dev, curve)
    q2x_bad, q2y_bad = q2x.clone(), q2y.clone()
    y_off = (convert.planes_to_ints(q2y[:, bad + 2:bad + 3].cpu().numpy())[0] + 1) % p
    q2y_bad[:, bad + 2] = to_dev([y_off], dev, d)[:, 0]
    q2x_bad[:, bad + 3] = to_dev([p], dev, d)[:, 0]
    s12, ok12 = ecdh.shared_secret_planes(d1_dev, q2x_bad, q2y_bad, curve)
    s21, ok21 = ecdh.shared_secret_planes(d2_dev, q1x, q1y, curve)
    k_ints = scalar_ints(rng, BATCH, [1, 2, 5, n - 2, n - 1], curve)
    k_dev = to_dev(k_ints, dev, d)
    base_strict = api.scalar_mult_base(k_dev, curve, strict=True)
    torch.cuda.synchronize()

    ones = torch.ones(BATCH, dtype=torch.int32, device=dev)
    want1 = ones.clone()
    want1[bad:bad + 2] = 0
    check(torch.equal(ok1, want1) and torch.equal(ok2, ones), f"{name} derive_public masks")
    want12 = ones.clone()
    want12[bad:] = 0
    check(torch.equal(ok12, want12), f"{name} shared_secret mask: the four invalid lanes")
    # Q1 on the two bad-scalar lanes is whatever the comb made of 0 and n;
    # the mask must say what an independent on-curve check of it says
    q1_bad = affine_ints(AffinePoint(q1x[:, bad:bad + 2], q1y[:, bad:bad + 2], curve), 2)
    host_ok = [int(x < p and y < p and (x, y) != (0, 0)
                   and (y * y - x**3 - curve.a * x - curve.b) % p == 0) for x, y in q1_bad]
    want21 = ones.clone()
    want21[bad:bad + 2] = torch.tensor(host_ok, dtype=torch.int32)
    check(torch.equal(ok21, want21), f"{name} shared_secret mask on the comb's outputs of 0, n")
    both = (ok12 & ok21).bool()
    check(int(both.sum()) == BATCH - 4, f"{name} ECDH valid lanes")
    check(torch.equal(s12[:, both], s21[:, both]), f"{name} d1*Q2 == d2*Q1 on every valid lane")
    sx = convert.planes_to_ints(s21[:, :MAIN_ORACLE_LANES].cpu().numpy())
    check(sx == [x for x, _ in oracle_base([a * b % n for a, b in zip(d1, d2[:MAIN_ORACLE_LANES])],
                                           curve)], f"{name} shared secrets vs oracle")
    check(affine_ints(base_strict, ORACLE_LANES) == oracle_base(k_ints[:ORACLE_LANES], curve),
          f"{name} scalar_mult_base(strict) vs oracle (n - 1 on lane 4)")
    say(f"phase {phase} {name} ECDH and strict keygen B={BATCH}: masks exact (4 invalid lanes), "
          f"d1*Q2 == d2*Q1 on {BATCH - 4} lanes, {MAIN_ORACLE_LANES} secrets vs oracle; "
          f"scalar_mult_base(strict) {ORACLE_LANES} lanes vs oracle (1, 2, 5, n-2, n-1 first); "
          f"timed with the phase's entry points")
    return {"ecdh.derive_public_planes": (lambda: ecdh.derive_public_planes(d2_dev, curve), 10),
            "ecdh.shared_secret_planes": (
                lambda: ecdh.shared_secret_planes(d2_dev, q1x, q1y, curve), 5),
            "scalar_mult_base_strict": (
                lambda: api.scalar_mult_base(k_dev, curve, strict=True), 10)}


def time_calls(calls):
    """{name: (call, repetitions)} -> {name: CUDA-event ms of one call}."""
    return {k: time_ms(fn, n) for k, (fn, n) in calls.items()}


def curve_phase(rng, dev, card, counted, curve):
    """Phase 18 on ``curve`` (secp256k1 or Wei25519): the main path through
    the entry points at B = 524,288, its checks, then each new kernel
    against its plain version (K and one-chain L: kernel B, itself held to
    comb_plain) on the path's own inputs, and the times. The plain versions
    run in the plain pool beside the path, as phase 19's (plain_ms is
    timed there). Returns the numbers of the kernels line."""
    tag = CURVES18[curve]
    fs, n = curve.field, curve.order
    kern = curve_kernels(curve)
    ks = scalar_ints(rng, BATCH, [1, 2, 5, n - 2, n - 1], curve)
    scalars = to_dev(ks, dev)
    points = varbase_points(BATCH, dev, curve)
    xm = GFp.from_classical(points.x, fs).planes.contiguous()
    ym = GFp.from_classical(points.y, fs).planes.contiguous()
    k_shared = scalar_ints(rng, 1, [], curve)[0]
    nb = comb.device_tables(curve, curve.gx, curve.gy, dev)[2]
    mma = comb.mma_tables(curve, curve.gx, curve.gy, dev)
    tables_np, negbase_ints = comb.base_tables(curve, curve.gx, curve.gy)
    classical = ocomb.classical_tables(tables_np, fs)

    # the plain versions of the kernel checks below, on the first
    # CHECK_LANES lanes of the path's inputs (since phase 19 was added: at
    # full width they took ~200 s), start now in the plain pool
    m = CHECK_LANES
    sc, xc, yc = (t[:, :m].contiguous() for t in (scalars, xm, ym))
    host = [t.cpu().numpy() for t in (sc, xc, yc)]
    plain = {"ladder": plain_submit("ladder", curve, False, host, dev.type),
             "comb_tree": plain_submit("comb_tree", curve, False, host[:1], dev.type)}
    for st in (False, True):
        plain[("window", st)] = plain_submit("window", curve, st, host, dev.type)
        plain[("comb", st)] = plain_submit("comb", curve, st, host[:1], dev.type)
    for c in sorted({kw["chains"] for kw in SCHEDULES.values() if kw.get("chains", 1) > 1}):
        plain[("comb_chains", c)] = plain_submit("comb_chains", curve, False, host[:1], dev.type,
                                                 c)

    # -- the path: every entry point of this slice on this curve
    zero_counts(counted)
    res = {"scalar_mult": api.scalar_mult(scalars, points),
           "scalar_mult_fast": api.scalar_mult_fast(scalars, points),
           "scalar_mult_fast_strict": api.scalar_mult_fast(scalars, points, strict=True),
           "scalar_mult_shared_fast": api.scalar_mult_shared_fast(k_shared, points)}
    for kname, kw in SCHEDULES.items():
        res[kname] = affine.to_affine(comb.scalar_mult_base(scalars, curve, **kw))
    ecdh_calls = ecdh_path(rng, dev, card) if curve == WEI25519 else {}
    torch.cuda.synchronize()
    launches = read_counts(counted)
    for kname, kernel in kern.items():
        check(launches[kernel.symbol] >= 1, f"phase 18 path on {curve.name} launched {kname}")
    check(launches[affine.KERNELS[curve].symbol] >= len(res), f"phase 18 {curve.name} affine")

    # -- 512 lanes of each result against the oracle
    want_var = oracle_varbase(ks[:ORACLE_LANES], curve)
    want_base = oracle_base(ks[:ORACLE_LANES], curve)
    want_shared = oracle_varbase([k_shared] * ORACLE_LANES, curve)
    degenerate = {"window": window_degenerate_lanes(ks[:ORACLE_LANES], curve),
                  "shared": window_degenerate_lanes([k_shared] * ORACLE_LANES, curve),
                  "ladder": [i for i, k in enumerate(ks[:ORACLE_LANES]) if k == n - 1]}
    for kname, kw in SCHEDULES.items():
        flags = [] if kw.get("strict") else pmap(comb_degenerate, [
            (k, classical, negbase_ints, kw, curve) for k in ks[:ORACLE_LANES]])
        degenerate[kname] = [i for i, f in enumerate(flags) if f]
    excl = {"scalar_mult": "ladder", "scalar_mult_fast": "window",
            "scalar_mult_shared_fast": "shared"}
    for name, out in res.items():
        check(out.x.shape == (D, BATCH) and out.x.dtype == torch.int32, f"{name} output shape")
        check(bool(((out.x >= 0) & (out.x < 1 << 16)).all()), f"{name} digits in range")
        want = (want_shared if name == "scalar_mult_shared_fast" else want_base
                if name in SCHEDULES else want_var)
        skip = set(degenerate.get(excl.get(name, name), []))
        lanes = [i for i in range(ORACLE_LANES) if i not in skip]
        got = affine_ints(out, ORACLE_LANES)
        check([got[i] for i in lanes] == [want[i] for i in lanes],
              f"phase 18 {curve.name} {name} vs oracle")
    check(degenerate["ladder"] == [4], "n - 1, outside the ladder's domain, on lane 4")
    del res
    excluded = {k: len(v) for k, v in degenerate.items()}
    say(f"phase 18 {curve.name} main path B={BATCH}: launches {json.dumps(launches)}; "
          f"{ORACLE_LANES} lanes of each result vs oracle (edge scalars 1, 2, 5, n-2, n-1; "
          f"points (i+1)G; excluded lanes: {json.dumps(excluded)})")

    # -- each new kernel against its plain version (or kernel B) on the first
    # CHECK_LANES lanes of the path's inputs (the plain pool's results), and
    # the times at full width (these launches come after the counts were read)
    out = {k: {"plain_lanes": CHECK_LANES} for k in kern}

    def kernel_runs(s, x, y):
        """JSON name -> one call of each new kernel on scalars s, points (x, y)."""
        r = {f"ladder_{tag}": lambda: ladder.ladder_planes(s, x, y, curve),
             f"window_{tag}": lambda: window.window_planes(s, x, y, curve),
             f"window_strict_{tag}": lambda: window.window_planes(s, x, y, curve, True)}
        if curve == WEI25519:
            r["comb_strict_w25519"] = lambda: comb.comb_planes(s, mma, nb, curve, True)
        for kname, kw in SCHEDULES.items():
            r[f"{kname}_{tag}"] = lambda kw=kw: comb.schedule_planes(s, mma, nb, curve, **kw)
        return r

    runs, chk = kernel_runs(scalars, xm, ym), kernel_runs(sc, xc, yc)

    def plain_result(key):
        """The plain pool's planes (on the card) and milliseconds for ``key``."""
        want_np, ms = plain[key].result()
        return [torch.from_numpy(w).to(dev) for w in want_np], ms

    def check_against(kname, got, key):
        want, out[kname]["plain_ms"] = plain_result(key)
        out[kname]["err"] = max_abs_diff(got, want)
        check(out[kname]["err"] == 0, f"{kname} kernel == its plain version on {m} lanes")

    check_against(f"ladder_{tag}", chk[f"ladder_{tag}"](), "ladder")
    for st in (False, True):
        kname = f"window{'_strict' if st else ''}_{tag}"
        check_against(kname, chk[kname](), ("window", st))
    # kernel B, both modes (on Wei25519 strict is new), against comb_plain:
    # K and one-chain L are then held to kernel B, as in phase 17
    b_out, b_plain_ms = {}, {}
    for st in (False, True):
        want, b_plain_ms[st] = plain_result(("comb", st))
        b_out[st] = comb.comb_planes(sc, mma, nb, curve, st)
        err = max_abs_diff(b_out[st], want)
        check(err == 0, f"{curve.name} comb (strict={st}) kernel == comb_plain on {m} lanes")
    if curve == WEI25519:
        out["comb_strict_w25519"] |= {"plain_ms": b_plain_ms[True], "err": err}
    for kname, kw in SCHEDULES.items():
        name = f"{kname}_{tag}"
        if kw.get("chain") == "tree":
            check_against(name, chk[name](), "comb_tree")
        elif kw.get("chain") == "pipe" or kw["chains"] == 1:
            st = kw.get("strict", False)
            out[name]["plain_ms"] = b_plain_ms[st]
            out[name]["err"] = max_abs_diff(chk[name](), b_out[st])
            check(out[name]["err"] == 0, f"{name} kernel == kernel B on {m} lanes")
        else:
            check_against(name, chk[name](), ("comb_chains", kw["chains"]))
    del b_out, chk
    for name, run in runs.items():
        out[name]["ms"] = time_ms(run, 5 if name.startswith(("ladder", "window")) else 20)
        kw = SCHEDULES.get(name.removesuffix(f"_{tag}"), {})
        if "chains" in kw:  # kernel L: its shared memory at this schedule
            out[name] |= general_smem(curve, name, kern[name], kw)
    api_ms = {"scalar_mult": time_ms(lambda: api.scalar_mult(scalars, points), 5),
              "scalar_mult_fast": time_ms(lambda: api.scalar_mult_fast(scalars, points), 5),
              "scalar_mult_fast_strict": time_ms(
                  lambda: api.scalar_mult_fast(scalars, points, strict=True), 5),
              "scalar_mult_shared_fast": time_ms(
                  lambda: api.scalar_mult_shared_fast(k_shared, points), 5),
              **{f"comb.scalar_mult_base({schedule_args(k)}) + affine": time_ms(
                  lambda kw=kw: affine.to_affine(comb.scalar_mult_base(scalars, curve, **kw)),
                  10) for k, kw in SCHEDULES.items()},
              **time_calls(ecdh_calls)}
    say(f"phase 18 {curve.name} kernels exact vs their plain versions (K, one-chain L: kernel "
          f"B, itself exact vs comb_plain) on the path's first {CHECK_LANES} lanes; L's staged "
          f"positions a step and shared memory {json.dumps(staged_smem(out))}; kernel ms "
          f"{json.dumps({k: round(v['ms'], 3) for k, v in out.items()})}; plain ms "
          f"{json.dumps({k: round(v['plain_ms'], 1) for k, v in out.items()})}; entry points ms "
          f"{json.dumps({k: round(v, 3) for k, v in api_ms.items()})} {card}")
    return {"launches": launches, "kernels": kern, "by_kernel": out,
            "api_ms": {f"{curve.name} {k}": v for k, v in api_ms.items()}}


def ecdsa_path(rng, dev, card, counted, curve, phase=12):
    """ECDSA on ``curve`` at ECDSA_BATCH lanes (phase 12: P-256, secp256k1;
    phase 19: P-384, its z planes as wide as its field, a SHA-384-sized
    hash): keys, sign, verify of the honest and a tampered batch, recover
    with v = 0 and 1, their checks and times. Resets the launch counts of
    ``counted`` first and returns them with the times and the path's
    tensors."""
    n, p, nd = curve.order, curve.p, curve.field.ndigits
    fs_n = ecdsa.order_field(curve)
    d_ints = scalar_ints(rng, ECDSA_BATCH, [1, 2, 5, n - 2], curve)
    k_ints = scalar_ints(rng, ECDSA_BATCH, [n - 2, 5, 2, 1], curve)
    z_ints = [int.from_bytes(rng.bytes(curve.field.nbits // 8), "big")
              for _ in range(ECDSA_BATCH)]
    z_ints[4] = n  # e == 0 mod n: u1 == 0 in verification
    rfc = curve == P256
    if rfc:  # lanes 8..15: RFC 6979 A.2.5 keys, hashes and nonces
        for i in range(8, 16):
            msg, k_rfc, _, _ = RFC6979_SHA256[i % 2]
            h1 = hashlib.sha256(msg).digest()
            d_ints[i], z_ints[i] = RFC6979_X, ecdsa._bits2int(h1, 256)
            k_ints[i] = ecdsa.rfc6979_nonce(h1, RFC6979_X, curve)
            check(k_ints[i] == k_rfc, "RFC 6979 A.2.5 nonce")
    d_dev, k_dev, z_dev = (to_dev(v, dev, nd) for v in (d_ints, k_ints, z_ints))
    vid = [torch.full((ECDSA_BATCH,), v, dtype=torch.int32, device=dev) for v in (0, 1)]

    # the tampered batch: lanes 500..505 r + 1, s = 0, s = n, r = 0, an
    # off-curve Q and (secp256k1) a valid signature with u2 = lambda
    t = ORACLE_LANES - 12

    def tampered(r, s, q):
        z_t, r_t, s_t, qx_t, qy_t = z_dev.clone(), r.clone(), s.clone(), q.x.clone(), q.y.clone()
        r_t[:, t] = to_dev([(convert.planes_to_ints(r[:, t:t + 1].cpu().numpy())[0] + 1) % n],
                           dev, nd)[:, 0]
        s_t[:, t + 1] = 0
        s_t[:, t + 2] = to_dev([n], dev, nd)[:, 0]
        r_t[:, t + 3] = 0
        y_off = (convert.planes_to_ints(q.y[:, t + 4:t + 5].cpu().numpy())[0] + 1) % p
        qy_t[:, t + 4] = to_dev([y_off], dev, nd)[:, 0]
        if curve == SECP256K1:
            lam = glv.glv_params(curve).lam
            dd, kk = d_ints[t + 5], k_ints[t + 5]
            rr = oracle_sign(0, dd, kk, curve)[0]
            ss = rr * pow(lam, -1, n) % n
            zz = ss * (kk - lam * dd) % n
            qq = coz.scalar_mult_affine(dd, curve.gx, curve.gy, curve)
            for tens, v in ((z_t, zz), (r_t, rr), (s_t, ss), (qx_t, qq[0]), (qy_t, qq[1])):
                tens[:, t + 5] = to_dev([v], dev)[:, 0]
        return z_t, r_t, s_t, qx_t, qy_t

    zero_counts(counted)
    q = api.scalar_mult_base(d_dev, curve)
    r, s, ok = ecdsa.sign_planes(z_dev, d_dev, k_dev, curve)
    v_ok = ecdsa.verify_planes(z_dev, r, s, q.x, q.y, curve)
    z_t, r_t, s_t, qx_t, qy_t = tampered(r, s, q)
    v_t = ecdsa.verify_planes(z_t, r_t, s_t, qx_t, qy_t, curve)
    rec = [ecdsa.recover_planes(z_dev, r, s, v, curve) for v in vid]
    torch.cuda.synchronize()
    launches = read_counts(counted)
    varbase_kernel = kglv.KERNEL_STRICT if curve == SECP256K1 else window.KERNELS[(curve, True)]
    for k in (comb.KERNELS[(curve, False)], affine.KERNELS[curve], varbase_kernel):
        check(launches[k.symbol] >= 1, f"ECDSA path on {curve.name} launched {k.symbol}")

    check(bool(ok.all()), f"{curve.name}: every lane signed")
    check(bool(v_ok.all()), f"{curve.name}: every honest signature verifies")
    ri = convert.planes_to_ints(r[:, :ORACLE_LANES].cpu().numpy())
    si = convert.planes_to_ints(s[:, :ORACLE_LANES].cpu().numpy())
    check(list(zip(ri, si))[:MAIN_ORACLE_LANES] == [
        oracle_sign(z, d, k, curve) for z, d, k in
        zip(z_ints[:MAIN_ORACLE_LANES], d_ints, k_ints)], f"{curve.name}: sign vs oracle")
    if rfc:
        got = zip(*(convert.planes_to_ints(v[:, 8:16].cpu().numpy()) for v in (r, s)))
        check(list(got) == [RFC6979_SHA256[i % 2][2:] for i in range(8, 16)],
              "8 RFC 6979 A.2.5 signatures")
    cols = [convert.planes_to_ints(t[:, :ORACLE_LANES].cpu().numpy())
            for t in (z_t, r_t, s_t, qx_t, qy_t)]
    want_t = pmap(oracle_verify, [(*lane, curve) for lane in zip(*cols)])
    check(v_t[:ORACLE_LANES].tolist() == want_t, f"{curve.name}: tampered masks vs oracle")
    tampered_lanes = want_t[t:t + 6]
    check(tampered_lanes == [0] * 5 + [1], f"{curve.name}: tampered lanes {tampered_lanes}")
    check(bool((v_t[ORACLE_LANES:] == 1).all()), f"{curve.name}: untouched lanes verify")
    found = torch.zeros(ECDSA_BATCH, dtype=torch.bool, device=dev)
    for qx_r, qy_r, ok_r in rec:
        found |= ok_r.bool() & (qx_r == q.x).all(0) & (qy_r == q.y).all(0)
    check(bool(found.all()), f"{curve.name}: v = 0 or v = 1 recovers Q on every lane")
    del v_t, rec, found

    # times: the calls, their kernels, and their plain-PyTorch parts; the
    # calls and the plain parts take seconds and ran above, so one warm
    # run each
    t = {"sign": time_once_ms(lambda: ecdsa.sign_planes(z_dev, d_dev, k_dev, curve))[0],
         "verify": time_once_ms(lambda: ecdsa.verify_planes(z_dev, r, s, q.x, q.y, curve))[0],
         "recover": time_once_ms(lambda: ecdsa.recover_planes(z_dev, r, s, vid[0], curve))[0]}
    mma_c = comb.mma_tables(curve, curve.gx, curve.gy, dev)
    nb_c = comb.device_tables(curve, curve.gx, curve.gy, dev)[2]
    jac = comb.comb_planes(d_dev, mma_c, nb_c, curve)
    t["kernel_comb"] = time_ms(lambda: comb.comb_planes(d_dev, mma_c, nb_c, curve), 10)
    t["kernel_affine"] = time_ms(lambda: affine.affine_planes(*jac, curve), 10)
    if curve == SECP256K1:
        packed = kglv.pack_scalars(d_dev, curve)
        qxm = GFp.from_classical(q.x, curve.field).planes.contiguous()
        qym = GFp.from_classical(q.y, curve.field).planes.contiguous()
        t["kernel_glv_strict"] = time_ms(
            lambda: kglv.glv_planes(packed, qxm, qym, curve, strict=True), 3)
        t["plain_glv_split"] = time_ms(lambda: kglv.pack_scalars(d_dev, curve), 3)
    else:
        t["kernel_window_strict"] = time_ms(
            lambda: window.window_planes(d_dev, q.x, q.y, curve, strict=True), 3)
    km = mont.mont_from_classical(k_dev.to(torch.int64), fs_n)
    t["plain_batch_inverse_mod_n"] = time_once_ms(
        lambda: ecdsa._batch_inverse_mont(km, fs_n))[0]
    t["plain_recovery_sqrt"] = time_once_ms(lambda: group.affine_from_x(r, curve))[0]
    out = {"launches": launches, "ms": t, "d": d_dev, "q": q, "jac": jac}
    if curve == SECP256K1:
        out.update(packed=packed, qxm=qxm, qym=qym)
    say(f"phase {phase} ECDSA {curve.name} B={ECDSA_BATCH}: launches {json.dumps(launches)}; every "
          f"lane signed and verified; {ORACLE_LANES} lanes of the tampered batch exact vs "
          f"oracle (r+1, s=0, s=n, r=0, off-curve Q rejected; "
          f"{'u2 = lambda' if curve == SECP256K1 else 'an honest'} lane accepted); hash = n "
          f"lane; recovery gives Q on every lane{'; RFC 6979 A.2.5 on 8 lanes' if rfc else ''}; "
          f"ms {json.dumps({k: round(v, 3) for k, v in t.items()})} {card}")
    return out


def wide_edges(p, words):
    """Field values that take the wide field layers' carry paths: 0, 1, 2,
    p - 1, p - 2, p - 2^32, a word of all ones in every place (reduced),
    p // 2 and its neighbour, 2^(32 words - 17) (reduced), and on P-521 the
    9-bit top word full and alone."""
    ones = (1 << (32 * words)) - 1
    vals = [0, 1, 2, p - 1, p - 2, p - (1 << 32), ones % p, p >> 1, (p >> 1) + 1,
            (1 << (32 * words - 17)) % p, (p - 1) // 3]
    if p.bit_length() == 521:
        vals += [0x1FF << 512, 1 << 512, (1 << 512) - 1]
    return sorted({v % p for v in vals})


def wide_phase(rng, dev, card, counted, curve):
    """Phase 19 on ``curve`` (P-384 or P-521): the main path through the
    entry points at B = 524,288 (and on P-384 ECDSA at 131,072 lanes,
    ``ecdsa_path``), its checks, then each kernel against its plain
    version on the first CHECK_LANES lanes of the path's own inputs (the
    plain P-521 ladder at full width would take minutes), kernel C against
    probe_plain, and the times. The plain versions of A, B, D and E run in
    the plain pool beside the path's first entry points (plain_ms is timed
    there, six processes sharing the card and the host); ECDH is timed
    after them and ECDSA waits for them, so that their times are the
    card's own. Returns the numbers of the kernels line."""
    tag = CURVES19[curve]
    fs, n, p, d = curve.field, curve.order, curve.p, curve.field.ndigits
    kern = wide_kernels(curve)
    ks = scalar_ints(rng, BATCH, [1, 2, 5, n - 2, n - 1], curve)
    scalars = to_dev(ks, dev, d)
    points = varbase_points(BATCH, dev, curve)
    xm = GFp.from_classical(points.x, fs).planes.contiguous()
    ym = GFp.from_classical(points.y, fs).planes.contiguous()
    k_shared = scalar_ints(rng, 1, [], curve)[0]
    nb = comb.device_tables(curve, curve.gx, curve.gy, dev)[2]
    mma = comb.mma_tables(curve, curve.gx, curve.gy, dev)
    tables_np, negbase_ints = comb.base_tables(curve, curve.gx, curve.gy)
    classical = ocomb.classical_tables(tables_np, fs)

    # the plain versions of the kernel checks below, on the first CHECK_LANES
    # lanes of the path's inputs, start now in the plain pool; kernel B's
    # output (lanes at infinity at group edges) is kernel D's input (launched
    # before the counts are reset, so not counted)
    m = CHECK_LANES
    s_c, x_c, y_c = (t[:, :m].contiguous() for t in (scalars, xm, ym))
    jx, jy, jz = affine_edge_input(comb.comb_planes(s_c, mma, nb, curve), curve)
    host = [t.cpu().numpy() for t in (s_c, x_c, y_c, jx, jy, jz)]
    plain = {f"ladder_{tag}": plain_submit("ladder", curve, False, host[:3], dev.type),
             f"affine_{tag}": plain_submit("affine", curve, False, host[3:], dev.type)}
    for st in (False, True):
        sfx = "_strict" if st else ""
        plain[f"window{sfx}_{tag}"] = plain_submit("window", curve, st, host[:3], dev.type)
        plain[f"comb{sfx}_{tag}"] = plain_submit("comb", curve, st, host[:1], dev.type)

    # -- the path: every entry point of this slice on this curve
    zero_counts(counted)
    res = {"scalar_mult": api.scalar_mult(scalars, points),
           "scalar_mult_fast": api.scalar_mult_fast(scalars, points),
           "scalar_mult_fast_strict": api.scalar_mult_fast(scalars, points, strict=True),
           "scalar_mult_shared_fast": api.scalar_mult_shared_fast(k_shared, points),
           "scalar_mult_base": api.scalar_mult_base(scalars, curve),
           "scalar_mult_base_strict": api.scalar_mult_base(scalars, curve, strict=True)}
    ecdh_calls = ecdh_path(rng, dev, card, curve, 19)
    torch.cuda.synchronize()
    launches = read_counts(counted)
    ecdsa_ms = {}
    if curve == P384:  # ECDSA resets the counts and returns its own
        # it times its calls itself: the plain versions, which share the
        # card, finish first
        concurrent.futures.wait(list(plain.values()))
        pe = ecdsa_path(rng, dev, card, counted, curve, 19)
        launches = sum_counts([launches, pe["launches"]])
        ecdsa_ms = {f"ecdsa.{k}": v for k, v in pe["ms"].items()}
    for kname, kernel in kern.items():
        if not kname.startswith("field_"):
            check(launches[kernel.symbol] >= 1, f"phase 19 path on {curve.name} launched {kname}")

    # -- 512 lanes of each result against the oracle
    want_var = oracle_varbase(ks[:ORACLE_LANES], curve)
    want_base = oracle_base(ks[:ORACLE_LANES], curve)
    want_shared = oracle_varbase([k_shared] * ORACLE_LANES, curve)
    degenerate = {"window": window_degenerate_lanes(ks[:ORACLE_LANES], curve),
                  "shared": window_degenerate_lanes([k_shared] * ORACLE_LANES, curve),
                  "ladder": [i for i, k in enumerate(ks[:ORACLE_LANES]) if k == n - 1],
                  "comb": [i for i, f in enumerate(pmap(comb_degenerate, [
                      (k, classical, negbase_ints, {}, curve) for k in ks[:ORACLE_LANES]])) if f]}
    excl = {"scalar_mult": "ladder", "scalar_mult_fast": "window",
            "scalar_mult_shared_fast": "shared", "scalar_mult_base": "comb"}
    for name, out in res.items():
        check(out.x.shape == (d, BATCH) and out.x.dtype == torch.int32, f"{name} output shape")
        check(bool(((out.x >= 0) & (out.x < 1 << 16)).all()), f"{name} digits in range")
        want = (want_shared if name == "scalar_mult_shared_fast" else want_base
                if name.startswith("scalar_mult_base") else want_var)
        skip = set(degenerate.get(excl.get(name), []))
        lanes = [i for i in range(ORACLE_LANES) if i not in skip]
        got = affine_ints(out, ORACLE_LANES)
        check([got[i] for i in lanes] == [want[i] for i in lanes],
              f"phase 19 {curve.name} {name} vs oracle")
    check(degenerate["ladder"] == [4], "n - 1, outside the ladder's domain, on lane 4")
    del res
    excluded = {k: len(v) for k, v in degenerate.items()}
    say(f"phase 19 {curve.name} main path B={BATCH}: launches {json.dumps(launches)}; "
          f"{ORACLE_LANES} lanes of each result vs oracle (edge scalars 1, 2, 5, n-2, n-1; "
          f"points (i+1)G; excluded lanes: {json.dumps(excluded)})")

    # -- each kernel against its plain version on the first CHECK_LANES lanes
    # of the path's inputs (the plain pool's results), and the times (these
    # launches come after the counts were read)
    out = {k: {"plain_lanes": m} for k in kern}

    def check_against(kname, run, want_np, ms):
        out[kname]["plain_ms"] = ms
        out[kname]["err"] = max_abs_diff(run(), [torch.from_numpy(w).to(dev) for w in want_np])
        check(out[kname]["err"] == 0, f"{kname} kernel == its plain version on {m} lanes")

    def plain_check(kname, run, plain):
        out[kname]["plain_ms"], want = time_once_ms(plain)
        out[kname]["err"] = max_abs_diff(run(), want)
        check(out[kname]["err"] == 0, f"{kname} kernel == its plain version on {m} lanes")

    runs_c = {f"ladder_{tag}": lambda: ladder.ladder_planes(s_c, x_c, y_c, curve),
              f"affine_{tag}": lambda: affine.affine_planes(jx, jy, jz, curve)}
    for st in (False, True):
        sfx = "_strict" if st else ""
        runs_c[f"window{sfx}_{tag}"] = lambda st=st: window.window_planes(s_c, x_c, y_c, curve, st)
        runs_c[f"comb{sfx}_{tag}"] = lambda st=st: comb.comb_planes(s_c, mma, nb, curve, st)
    for kname, job in plain.items():
        check_against(kname, runs_c[kname], *job.result())
    affine_edge_check(runs_c[f"affine_{tag}"](), (jx, jy, jz), curve, f"{curve.name} affine")
    # kernel C: the edge pairs first, then draws below p
    edges = wide_edges(p, (d + 1) // 2)
    pairs = [(x, y) for x in edges for y in edges]
    av = [x for x, _ in pairs] + [int.from_bytes(rng.bytes(80), "little") % p
                                  for _ in range(m - len(pairs))]
    bv = [y for _, y in pairs] + [int.from_bytes(rng.bytes(80), "little") % p
                                  for _ in range(m - len(pairs))]
    a_dev, b_dev = to_dev(av, dev, d), to_dev(bv, dev, d)
    pname = f"field_probe_{tag}"
    plain_check(pname, lambda: field_ops.probe(a_dev, b_dev, fs),
                lambda: field_ops.probe_plain(a_dev, b_dev, fs))
    got = field_ops.probe(a_dev, b_dev, fs)
    ints = [convert.planes_to_ints(got[k, :, :64].cpu().numpy()) for k in range(5)]
    check(ints == [[x * y % p for x, y in zip(av, bv[:64])], [x * x % p for x in av[:64]],
                   [(x + y) % p for x, y in zip(av, bv[:64])],
                   [(x - y) % p for x, y in zip(av, bv[:64])], [(-x) % p for x in av[:64]]],
          f"{pname} vs ints on 64 lanes")
    out[pname]["ms"] = time_ms(lambda: field_ops.probe(a_dev, b_dev, fs), 20)
    out[pname]["lanes"] = m
    # its constant-operand form: 1, 2, p - 1 and 0 as compile-time constants
    cname = f"field_consts_{tag}"
    plain_check(cname, lambda: field_ops.constants(fs, dev),
                lambda: field_ops.constants_plain(fs, dev))
    out[cname] |= {"ms": time_ms(lambda: field_ops.constants(fs, dev), 20), "lanes": 1,
                   "plain_lanes": 1}
    del jx, jy, jz

    jac = comb.comb_planes(scalars, mma, nb, curve)
    runs = {f"ladder_{tag}": lambda: ladder.ladder_planes(scalars, xm, ym, curve),
            f"window_{tag}": lambda: window.window_planes(scalars, xm, ym, curve),
            f"window_strict_{tag}": lambda: window.window_planes(scalars, xm, ym, curve, True),
            f"comb_{tag}": lambda: comb.comb_planes(scalars, mma, nb, curve),
            f"comb_strict_{tag}": lambda: comb.comb_planes(scalars, mma, nb, curve, True),
            f"affine_{tag}": lambda: affine.affine_planes(*jac, curve)}
    for name, run in runs.items():
        out[name]["ms"] = time_ms(run, 3 if name.startswith(("ladder", "window")) else 10)
    affine_large_check(jac, curve, f"{curve.name} affine")
    del jac
    api_ms = {"scalar_mult": time_ms(lambda: api.scalar_mult(scalars, points), 3),
              "scalar_mult_fast": time_ms(lambda: api.scalar_mult_fast(scalars, points), 3),
              "scalar_mult_fast_strict": time_ms(
                  lambda: api.scalar_mult_fast(scalars, points, strict=True), 3),
              "scalar_mult_shared_fast": time_ms(
                  lambda: api.scalar_mult_shared_fast(k_shared, points), 3),
              "scalar_mult_base": time_ms(lambda: api.scalar_mult_base(scalars, curve), 10),
              **time_calls(ecdh_calls), **ecdsa_ms}
    say(f"phase 19 {curve.name} kernels exact vs their plain versions on the path's first {m} "
          f"lanes (C on {len(pairs)} edge pairs and draws, 64 lanes vs ints, and on compile-time "
          f"constants); kernel ms at B={BATCH} "
          f"{json.dumps({k: round(v['ms'], 3) for k, v in out.items()})}; plain ms at {m} lanes "
          f"{json.dumps({k: round(v['plain_ms'], 1) for k, v in out.items()})}; entry points ms "
          f"{json.dumps({k: round(v, 3) for k, v in api_ms.items()})} {card}")
    return {"launches": launches, "kernels": kern, "by_kernel": out,
            "api_ms": {f"{curve.name} {k}": v for k, v in api_ms.items()}}


# phase 21: lanes i and i + BATCH / 2 hold equal points times equal scalars
# for i < MSM_PAIRS, opposite points times equal scalars for MSM_PAIRS <= i <
# 2 MSM_PAIRS; the SEC1 round trip's lanes and its invalid forms
MSM_PAIRS = 4096
SEC1_LANES = 65536
SEC1_BAD = 16  # lanes of each invalid form


def sec1_blobs(rng, pts_x, pts_y, curve):
    """SEC1_LANES encodings of the affine planes' first lanes (even lanes
    compressed, odd uncompressed; encoding.points_to_bytes), then SEC1_BAD
    lanes of each invalid form in place of some: a bad prefix, a bad length,
    x = p, y = p, a point off the curve, the infinity 0x00, (0, 0)
    uncompressed, and a compressed x with no square root. Returns the blobs
    and the lanes of the invalid ones."""
    p, length = curve.p, encoding.coordinate_bytes(curve)
    m = SEC1_LANES
    sub = AffinePoint(pts_x[:, :m], pts_y[:, :m], curve)
    comp, unc = encoding.points_to_bytes(sub), encoding.points_to_bytes(sub, compressed=False)
    blobs = [comp[i] if i % 2 == 0 else unc[i] for i in range(m)]
    enc = lambda v: v.to_bytes(length, "big")  # noqa: E731
    nonres = next(v for v in range(2, 1000)
                  if pow((v ** 3 + curve.a * v + curve.b) % p, (p - 1) // 2, p) == p - 1)
    lanes = rng.choice(np.arange(ORACLE_LANES, m), size=8 * SEC1_BAD, replace=False)
    for j, i in enumerate(lanes.tolist()):
        b, form = unc[i], j // SEC1_BAD
        x, y = b[1:1 + length], b[1 + length:]
        blobs[i] = [b"\x05" + x, b"\x02" + x[1:], b"\x03" + enc(p), b"\x04" + x + enc(p),
                    b"\x04" + x + enc((int.from_bytes(y, "big") + 1) % p), b"\x00",
                    b"\x04" + enc(0) + enc(0), b"\x02" + enc(nonres)][form]
    return blobs, sorted(lanes.tolist())


def batch_sum_order2_check(dev):
    """Kernel M on Wei25519 with its point of order 2, T = (A / 3, 0): T + T
    (z = 0, the general-a doubling's x and y), inf + T, T + P, P + T and
    T + inf, on 64 lanes against the plain group.batch_sum level and tree."""
    curve, p = WEI25519, WEI25519.p
    t = (486662 * pow(3, -1, p) % p, 0)
    pts = multiples_of_g(64, curve)[:64]
    zs = [(5 * i + 2) % p for i in range(64)]
    lanes = [(x * z * z % p, y * z ** 3 % p, z) for (x, y), z in zip(pts, zs)]
    lanes[0] = lanes[32] = (t[0], 0, 1)
    lanes[33] = (t[0] * 9 % p, 0, 3)
    lanes[1] = (7, 11, 0)
    lanes[2] = (t[0], 0, 1)
    lanes[35] = (t[0] * 4 % p, 0, 2)
    lanes[4], lanes[36] = (t[0], 0, 1), (13, 17, 0)
    cols = [to_dev([v[j] for v in lanes], dev) for j in range(3)]
    jac = JacobianPoint(*(GFp(c, curve.field) for c in cols), curve)
    got = batch_sum.level_planes(*cols, curve)
    h = 32
    half = lambda lo, hi: JacobianPoint(  # noqa: E731
        *(GFp(c[:, lo:hi].contiguous(), curve.field) for c in cols), curve)
    want = group.jac_add_complete(half(0, h), half(h, 2 * h))
    err = max_abs_diff(got, (want.x.planes, want.y.planes, want.z.planes))
    check(err == 0 and not bool(got[2][:, 0].any()),
          "Wei25519 kernel M == plain on its point of order 2 (T + T at z = 0)")
    tree = batch_sum.batch_sum_planes(*cols, curve)
    plain = group.batch_sum(jac)
    err = max(err, max_abs_diff(tree, (plain.x.planes, plain.y.planes, plain.z.planes)))
    check(err == 0, "Wei25519 kernel M tree == plain batch_sum with its point of order 2")
    return err


def msm_phase(rng, dev, card, counted, curve):
    """Phase 21 on ``curve``: multi-scalar multiplication, the shared-scalar
    ladder and SEC1 through the entry points at B = 524,288 (points c_i G
    from the comb, launched before the counts are reset), their checks, then
    kernel M against the plain batch sum on the path's own per-lane
    products, and the times. Returns the numbers of the kernels line."""
    tag = _build.CURVE_TAGS[curve][0]
    n, p, d = curve.order, curve.p, curve.field.ndigits
    kernel = batch_sum.KERNELS[curve]
    kname = tagged(curve, "batch_sum")
    h = BATCH // 2
    cs = scalar_ints(rng, BATCH, [], curve)
    ks = scalar_ints(rng, BATCH, [], curve)
    for i in range(MSM_PAIRS):
        cs[h + i], ks[h + i] = cs[i], ks[i]
        j = MSM_PAIRS + i
        cs[h + j], ks[h + j] = n - cs[j], ks[j]
    # a second batch whose sum is infinity: its last scalar cancels the rest
    k_last = -sum(k * c for k, c in zip(ks[:-1], cs[:-1])) * pow(cs[-1], -1, n) % n
    check(k_last != 0, "phase 21: the cancelling scalar is not 0")
    total = sum(k * c for k, c in zip(ks, cs)) % n
    k_shared = scalar_ints(rng, 1, [], curve)[0]
    points = api.scalar_mult_base(to_dev(cs, dev, d), curve, strict=True)
    s_dev = to_dev(ks, dev, d)
    s0_dev = s_dev.clone()
    s0_dev[:, -1:] = to_dev([k_last], dev, d)
    torch.cuda.synchronize()

    # -- the path
    zero_counts(counted)
    t0 = time.perf_counter()
    msm = api.multi_scalar_mult(s_dev, points)
    msm0 = api.multi_scalar_mult(s0_dev, points)
    shared = api.scalar_mult_shared(k_shared + (1 << curve.field.nbits), points)
    blobs, bad = sec1_blobs(rng, points.x, points.y, curve)
    decode_ms, (dec, ok) = time_once_ms(
        lambda: encoding.points_from_bytes(blobs, curve, device=dev))
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = read_counts(counted)
    strict = kglv.KERNEL_STRICT if curve == SECP256K1 else window.KERNELS[(curve, True)]
    for k in (kernel, strict, ladder.KERNELS[curve], affine.KERNELS[curve]):
        check(launches[k.symbol] >= 1, f"phase 21 path on {curve.name} launched {k.symbol}")
    check(launches[kernel.symbol] == 2 and launches.shapes[kernel.symbol] == {
        (BATCH, (BATCH - 1).bit_length()): 2},
          f"phase 21 {curve.name}: kernel M launched once a sum, the whole tree")

    # -- the checks: the sums by linearity, the ladder and SEC1 exactly
    check(msm.x.planes.shape == (d, 1) and bool(msm0.z.is_zero()[0]),
          f"phase 21 {curve.name}: a 1-lane sum, and the cancelling batch's at infinity")
    got = affine_ints(affine.to_affine(msm), 1)[0]
    check(got == oracle_mult(total, (curve.gx, curve.gy), curve),
          f"phase 21 {curve.name} multi_scalar_mult == (sum k_i c_i mod n) G")
    want = oracle_base([k_shared * c % n for c in cs[:ORACLE_LANES]], curve)
    check(affine_ints(shared, ORACLE_LANES) == want,
          f"phase 21 {curve.name} scalar_mult_shared vs oracle on {ORACLE_LANES} lanes")
    check(shared.x.shape == (d, BATCH) and bool(((shared.x >= 0) & (shared.x < 1 << 16)).all()),
          f"phase 21 {curve.name} scalar_mult_shared output")
    want_ok = np.ones(SEC1_LANES, bool)
    want_ok[bad] = False
    check(np.array_equal(ok, want_ok), f"phase 21 {curve.name} SEC1 masks exact")
    okm = torch.from_numpy(want_ok).to(dev)
    for got_c, src in ((dec.x, points.x), (dec.y, points.y)):
        check(torch.equal(got_c[:, okm], src[:, :SEC1_LANES][:, okm])
              and not bool(got_c[:, ~okm].any()),
              f"phase 21 {curve.name} SEC1 points: the sources on valid lanes, 0 on the rest")
    back = encoding.points_to_bytes(dec)
    check(all(back[i] == blobs[i] for i in range(0, SEC1_LANES, 2) if want_ok[i]),
          f"phase 21 {curve.name} SEC1 compressed lanes encode back to their bytes")
    say(f"phase 21 {curve.name} path B={BATCH} ({path_s:.1f} s): launches "
        f"{json.dumps(launches)}; multi_scalar_mult == the oracle's (sum k_i c_i) G with "
        f"{MSM_PAIRS} equal and {MSM_PAIRS} opposite pairs at the first level, a second batch "
        f"at infinity; scalar_mult_shared (k + 2^nbits) {ORACLE_LANES} lanes vs oracle; SEC1 "
        f"{SEC1_LANES} mixed encodings, {len(bad)} invalid, masks exact")

    # -- kernel M against the plain batch sum on the path's per-lane products
    prod = kglv.strict_varbase(s_dev, points)
    r = tuple(c.planes for c in (prod.x, prod.y, prod.z))
    lvl = batch_sum.level_planes(*r, curve)
    half = lambda lo, hi: JacobianPoint(  # noqa: E731
        *(GFp(c[:, lo:hi].contiguous(), curve.field) for c in r), curve)
    level_plain_ms, want = time_once_ms(lambda: group.jac_add_complete(half(0, h),
                                                                       half(h, BATCH)))
    err = max_abs_diff(lvl, (want.x.planes, want.y.planes, want.z.planes))
    check(err == 0, f"{kname} == the plain complete add on the first level's {h} lanes")
    check(not bool(lvl[2][:, MSM_PAIRS:2 * MSM_PAIRS].any()) and bool(
        lvl[2][:, :MSM_PAIRS].any(dim=0).all()),
        f"{kname}: opposite pairs at infinity, equal pairs doubled")
    del want
    plain_ms, plain = time_once_ms(lambda: group.batch_sum(prod))
    tree = batch_sum.batch_sum_planes(*r, curve)
    err = max(err, max_abs_diff(tree, (plain.x.planes, plain.y.planes, plain.z.planes)),
              max_abs_diff(tree, (msm.x.planes, msm.y.planes, msm.z.planes)))
    check(err == 0, f"{kname} tree == plain batch_sum's final lane == the path's sum")
    if curve == WEI25519:
        err = max(err, batch_sum_order2_check(dev))
    threads, blocks = batch_sum.THREADS, batch_sum.blocks_per_sm(curve)
    sizes = (2, 3, threads - 1, threads + 1, 2 * threads - 1, 2 * threads + 1, 1001, BATCH - 1)
    for m in sizes:  # the grid's hand-off to one block, and odd tails
        sub = tuple(c[:, :m].contiguous() for c in r)
        got = batch_sum.batch_sum_planes(*sub, curve)
        want = group.batch_sum(JacobianPoint(*(GFp(c, curve.field) for c in sub), curve))
        err = max(err, max_abs_diff(got, (want.x.planes, want.y.planes, want.z.planes)))
        check(err == 0, f"{kname} tree == plain batch_sum on {m} lanes")
    runs = [time_ms(lambda: batch_sum.batch_sum_planes(*r, curve), 20) for _ in range(5)]
    ms = sum(runs) / len(runs)
    level_ms = time_ms(lambda: batch_sum.level_planes(*r, curve), 20)
    floor = btree.depth_floor(r, curve, 10, BATCH, profile=False)
    del prod, r, lvl, plain, tree
    api_ms = {"multi_scalar_mult": time_ms(lambda: api.multi_scalar_mult(s_dev, points), 3),
              "scalar_mult_shared": time_ms(lambda: api.scalar_mult_shared(k_shared, points), 3)}
    t0 = time.perf_counter()
    encoding.points_to_bytes(AffinePoint(points.x[:, :SEC1_LANES], points.y[:, :SEC1_LANES],
                                         curve))
    api_ms["encoding.points_to_bytes"] = (time.perf_counter() - t0) * 1e3
    api_ms["encoding.points_from_bytes"] = decode_ms  # the path's own call
    say(f"phase 21 {curve.name} {kname} ({threads} threads a block, {blocks} blocks an SM) "
        f"exact vs the plain batch sum (first level, {h} lanes; final lane; trees of "
        f"{', '.join(map(str, sizes))} lanes); kernel M {ms:.3f} ms a tree of {BATCH} lanes "
        f"(one launch; five runs of 20: {', '.join(f'{v:.3f}' for v in runs)}), first level "
        f"{level_ms:.3f} ms; depth floor {floor['depth_floor_ms']:.3f} ms (one level "
        f"{floor['event_slope_ms']:.4f} ms, the slope of {floor['depth_floor_from']} over "
        f"trees of 2^1 .. 2^10 lanes); plain "
        f"{plain_ms:.1f} ms, its first level {level_plain_ms:.1f} ms; entry points ms "
        f"{json.dumps({k: round(v, 3) for k, v in api_ms.items()})} (SEC1 on {SEC1_LANES} "
        f"lanes, host clock for the encoder) {card}")
    return {"launches": launches, "kernel": kernel, "name": kname, "err": err, "ms": ms,
            "ms_runs": runs, "threads": threads, "handoff_sizes": sizes, "depth_floor": floor,
            "plain_ms": plain_ms, "level_ms": level_ms, "level_plain_ms": level_plain_ms,
            "api_ms": {f"{curve.name} {k}": v for k, v in api_ms.items()}}


def main():
    """Run the phases with the oracle pool (pmap) and the plain pool
    (plain_submit) up, and shut them down."""
    global _POOL, _PLAIN_POOL
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(ORACLE_WORKERS, mp_context=ctx) as pool, \
            concurrent.futures.ProcessPoolExecutor(PLAIN_WORKERS, mp_context=ctx) as plain:
        _POOL, _PLAIN_POOL = pool, plain
        try:
            return run()
        finally:
            _POOL = _PLAIN_POOL = None


def run():
    t_start = time.perf_counter()
    # -- phase 0: device ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels run only on an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    sm_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    card = f"[{smi}]"
    say(f"phase 0 device: {name}; nvidia-smi: {smi}; max SM clock {sm_clock_mhz:.0f} MHz; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)
    rng = np.random.default_rng(SEED)

    # -- phase 1: build ----------------------------------------------------------
    build = _build.library()
    for _ in range(ORACLE_WORKERS):  # start the oracle pool's processes beside phases 1-2
        _POOL.submit(int)
    res = resource_report(build.log)
    say(f"phase 1 build: {build.seconds:.1f} s nvcc ({len(_build.SOURCES)} sources in "
          f"parallel); ptxas {json.dumps(res)}")
    for kname in PTXAS_NAMES:
        check(kname in res and "registers" in res[kname], f"ptxas report for {kname}")
    say(f"phase 1 nvcc seconds by source: "
          f"{json.dumps({k: round(v, 1) for k, v in build.source_seconds.items()})}")
    say("phase 1 ptxas, kernels E and F (registers / spill bytes stored / loaded; E on P-384 "
          "and P-521 too, kernels A, B, C, D of phase 19 in the line above): " + ", ".join(
        f"{k} {res[k]['registers']} / {res[k]['spill_stores']} / {res[k]['spill_loads']}"
        for k in ("window", "window_strict", "glv", "glv_strict",
                  *(f"window{st}_{tag}" for tag in (*CURVES18.values(), *CURVES19.values())
                    for st in ("", "_strict")))))
    # the SASS mix is host work (cuobjdump and its parse): a pool process
    # does it beside the phases, and its line follows phase 19's
    sass_job = _POOL.submit(sass.report, build.path)

    # -- phase 2: field probe ----------------------------------------------------
    a = random_planes(rng, CHECK_LANES)
    b = random_planes(rng, CHECK_LANES)
    pairs = [(x, y) for x in carry_edges(P) for y in carry_edges(P)]
    a[:, : len(pairs)] = convert.ints_to_planes([x for x, _ in pairs], D)
    b[:, : len(pairs)] = convert.ints_to_planes([y for _, y in pairs], D)
    a_dev, b_dev = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    got = field_ops.probe(a_dev, b_dev)
    want = field_ops.probe_plain(a_dev, b_dev)
    torch.cuda.synchronize()
    probe_err = max_abs_diff(got, want)
    check(probe_err == 0, "field probe == plain GFp")
    ai, bi = convert.planes_to_ints(a[:, :64]), convert.planes_to_ints(b[:, :64])
    ints = [convert.planes_to_ints(got[k, :, :64].cpu().numpy()) for k in range(5)]
    check(ints[0] == [x * y % P for x, y in zip(ai, bi)], "probe mul vs ints")
    check(ints[1] == [x * x % P for x in ai], "probe sqr vs ints")
    check(ints[2] == [(x + y) % P for x, y in zip(ai, bi)], "probe add vs ints")
    check(ints[3] == [(x - y) % P for x, y in zip(ai, bi)], "probe sub vs ints")
    check(ints[4] == [(-x) % P for x in ai], "probe opposite vs ints")
    probe_ms = time_ms(lambda: field_ops.probe(a_dev, b_dev), 20)
    probe_plain_ms = time_ms(lambda: field_ops.probe_plain(a_dev, b_dev), 3)
    say(f"phase 2 field probe: {CHECK_LANES} lanes exact vs plain GFp (carry_edges pairs "
          f"first) and 64 vs ints; "
          f"kernel {probe_ms:.3f} ms, plain {probe_plain_ms:.3f} ms {card}")

    # -- phase 3: comb -----------------------------------------------------------
    tables, negbase, negbase_digits = comb.device_tables(P256, P256.gx, P256.gy, dev)
    mma = comb.mma_tables(P256, P256.gx, P256.gy, dev)
    s_np = scalar_planes(rng, CHECK_LANES)
    s_dev = torch.from_numpy(s_np).to(dev)
    comb_got = comb.comb_planes(s_dev, mma, negbase_digits)
    want = comb.comb_plain(s_dev, tables, P256, negbase)
    torch.cuda.synchronize()
    comb_check_err = max_abs_diff(comb_got, want)
    check(comb_check_err == 0, "comb kernel == comb_plain (Jacobian)")
    ks = convert.planes_to_ints(s_np[:, :ORACLE_LANES])
    want_base = oracle_base(ks)
    check(jacobian_affine_ints(comb_got, ORACLE_LANES) == want_base, "comb vs oracle")
    say(f"phase 3 comb: {CHECK_LANES} lanes exact vs comb_plain; {ORACLE_LANES} lanes "
          f"vs oracle (edge scalars 1, 2, 5, n-2)")

    # -- phase 4: ladder ---------------------------------------------------------
    # its plain version (~25 s, launch-bound at any width) runs once, on the
    # main path's 524,288 lanes in phase 6
    pts = varbase_points(CHECK_LANES, dev)
    got = ladder.ladder_planes(s_dev, pts.x, pts.y)
    check(jacobian_affine_ints(got, ORACLE_LANES) == oracle_varbase(ks), "ladder vs oracle")
    say(f"phase 4 ladder: {ORACLE_LANES} lanes with points (i+1)G vs oracle (against "
          f"group.scalar_mult in phase 6)")

    # -- phase 5: affine conversion ----------------------------------------------
    jx, jy, jz = affine_edge_input(comb_got, P256)
    got = affine.affine_planes(jx, jy, jz)
    plain = JacobianPoint(*(GFp(t, P256.field) for t in (jx, jy, jz)), P256).to_affine()
    torch.cuda.synchronize()
    affine_check_err = max_abs_diff(got, (plain.x, plain.y))
    check(affine_check_err == 0, "affine kernel == JacobianPoint.to_affine")
    affine_edge_check(got, (jx, jy, jz), P256, "P-256 affine")
    check(affine_ints(AffinePoint(*got, P256), ORACLE_LANES) == want_base, "affine vs oracle")
    say(f"phase 5 affine (threads, lanes a thread, block tree: "
          f"{affine.layout(P256, CHECK_LANES)}): {CHECK_LANES} comb results exact vs JacobianPoint.to_affine (lanes at infinity at "
          f"group edges); a ragged batch; {ORACLE_LANES} lanes vs oracle")

    # -- phase 6: the first main path at B = 524,288 ------------------------------
    s_np = scalar_planes(rng, BATCH)
    scalars = torch.from_numpy(s_np).to(dev)
    points = varbase_points(BATCH, dev)
    counted = (*comb.KERNELS.values(), *ladder.KERNELS.values(), *window.KERNELS.values(),
               *affine.KERNELS.values(), *field_ops.KERNELS.values(),
               *field_ops.KERNELS_CONSTS.values(), kglv.KERNEL,
               kglv.KERNEL_STRICT, mladder.KERNEL, mladder.KERNEL_XDIVZ, roofline.KERNEL,
               *comb.KERNELS_TREE.values(), *comb.KERNELS_PIPE.values(),
               *comb.KERNELS_GENERAL.values(), *batch_sum.KERNELS.values())
    zero_counts(counted)
    out_base = api.scalar_mult_base(scalars)
    out_var = api.scalar_mult(scalars, points)
    torch.cuda.synchronize()
    launches6 = read_counts(counted)
    for k in (comb.KERNEL, ladder.KERNEL, affine.KERNEL):
        check(launches6[k.symbol] >= 1, f"main path launched {k.symbol}")
    for out in (out_base, out_var):
        check(out.x.shape == (D, BATCH) and out.y.shape == (D, BATCH), "output shape")
        check(out.x.dtype == torch.int32, "output dtype")
        check(bool(((out.x >= 0) & (out.x < 1 << 16)).all()), "output digits in range")
    ks = convert.planes_to_ints(s_np[:, :MAIN_ORACLE_LANES])
    check(affine_ints(out_base, MAIN_ORACLE_LANES) == oracle_base(ks), "main path k*G vs oracle")
    check(affine_ints(out_var, MAIN_ORACLE_LANES) == oracle_varbase(ks), "main path k*P vs oracle")

    # each kernel against its plain version at the main path's shape
    comb_ms = time_ms(lambda: comb.comb_planes(scalars, mma, negbase_digits), 20)
    comb_plain_ms, comb_plain_out = time_once_ms(
        lambda: comb.comb_plain(scalars, tables, P256, negbase))
    jac_b = comb.comb_planes(scalars, mma, negbase_digits)
    comb_err = max_abs_diff(jac_b, comb_plain_out)
    check(comb_err == 0, "comb kernel == comb_plain at B = 524,288")
    del comb_plain_out
    affine_ms = time_ms(lambda: affine.affine_planes(*jac_b), 20)
    affine_plain_ms, plain = time_once_ms(
        lambda: JacobianPoint(*(GFp(t, P256.field) for t in jac_b), P256).to_affine())
    affine_err = max_abs_diff(affine.affine_planes(*jac_b), (plain.x, plain.y))
    check(affine_err == 0, "affine kernel == JacobianPoint.to_affine at B = 524,288")
    affine_large_check(jac_b, P256, "P-256 affine")
    del plain, jac_b
    ladder_ms = time_ms(lambda: ladder.ladder_planes(scalars, points.x, points.y), 5)
    ladder_plain_ms, plain = time_once_ms(
        lambda: group.scalar_mult(scalars, JacobianPoint.from_affine(points)))
    ladder_err = max_abs_diff(
        ladder.ladder_planes(scalars, points.x, points.y),
        (plain.x.planes, plain.y.planes, plain.z.planes))
    check(ladder_err == 0, "ladder kernel == group.scalar_mult at B = 524,288")
    del plain
    base_api_ms = time_ms(lambda: api.scalar_mult_base(scalars), 10)
    var_api_ms = time_ms(lambda: api.scalar_mult(scalars, points), 5)
    rate = lambda ms: BATCH / (ms / 1e3)  # noqa: E731
    say(f"phase 6 main path B={BATCH}: launches {json.dumps(launches6)}; 64 lanes of each vs "
          f"oracle; k*G comb kernel {comb_ms:.3f} ms ({rate(comb_ms):.0f} mults/s), plain "
          f"{comb_plain_ms:.1f} ms; k*P ladder kernel {ladder_ms:.3f} ms "
          f"({rate(ladder_ms):.0f} mults/s), plain {ladder_plain_ms:.1f} ms; affine kernel "
          f"{affine_ms:.3f} ms, plain {affine_plain_ms:.1f} ms; api.scalar_mult_base "
          f"{base_api_ms:.3f} ms ({rate(base_api_ms):.0f} mults/s), api.scalar_mult "
          f"{var_api_ms:.3f} ms ({rate(var_api_ms):.0f} mults/s); plain times at the same "
          f"shape, one run each {card}")

    # -- phase 7: signed window (kernel E), plain and strict ------------------------
    pts = varbase_points(CHECK_LANES, dev)
    window_check = {}
    for strict in (False, True):
        kname = "window_strict" if strict else "window"
        edges = EDGE_SCALARS + ([N - 1] if strict else [])
        s7_np = scalar_planes(rng, CHECK_LANES, edges)
        s7 = torch.from_numpy(s7_np).to(dev)
        got = window.window_planes(s7, pts.x, pts.y, strict=strict)
        err = max_abs_diff(got, window.window_plain(s7, pts.x, pts.y, P256, strict))
        check(err == 0, f"{kname} kernel == window_plain (Jacobian)")
        ks7 = convert.planes_to_ints(s7_np[:, :ORACLE_LANES])
        bad = [] if strict else window_degenerate_lanes(ks7)
        lanes = [i for i in range(len(ks7)) if i not in bad]
        check(strict or 3 not in lanes, "n-2 is a degenerate lane of the plain window")
        gaff, waff = jacobian_affine_ints(got, ORACLE_LANES), oracle_varbase(ks7)
        check([gaff[i] for i in lanes] == [waff[i] for i in lanes], f"{kname} vs oracle")
        window_check[kname] = err
        say(f"phase 7 {kname}: {CHECK_LANES} lanes exact vs window_plain; "
              f"{len(lanes)} of {ORACLE_LANES} lanes with points (i+1)G vs oracle "
              f"(edge scalars {'1, 2, 5, n-2, n-1' if strict else '1, 2, 5; degenerate lanes '}"
              f"{'' if strict else str(sorted(set(range(ORACLE_LANES)) - set(lanes)))})")
    del got

    # -- phase 8: strict comb (kernel B strict) -----------------------------------
    s8_np = scalar_planes(rng, CHECK_LANES, EDGE_SCALARS + [N - 1])
    s8 = torch.from_numpy(s8_np).to(dev)
    got = comb.comb_planes(s8, mma, negbase_digits, strict=True)
    comb_strict_check_err = max_abs_diff(
        got, comb.comb_plain(s8, tables, P256, negbase, strict=True))
    check(comb_strict_check_err == 0, "strict comb kernel == strict comb_plain (Jacobian)")
    ks8 = convert.planes_to_ints(s8_np[:, :ORACLE_LANES])
    check(jacobian_affine_ints(got, ORACLE_LANES) == oracle_base(ks8), "strict comb vs oracle")
    check(jacobian_affine_ints(got, 5)[4] == (P256.gx, P - P256.gy), "strict comb (n-1) G = -G")
    say(f"phase 8 comb_strict: {CHECK_LANES} lanes exact vs strict comb_plain; "
          f"{ORACLE_LANES} lanes vs oracle (edge scalars 1, 2, 5, n-2, n-1)")
    del got

    # -- phase 9: the second main path at B = 524,288 -----------------------------
    d1 = scalar_ints(rng, BATCH)
    d2 = scalar_ints(rng, BATCH, edges=[3, N - 2])
    bad = BATCH - 4  # lanes bad..bad+3: zero scalar, scalar = n, off-curve peer, x = p
    d1[bad], d1[bad + 1] = 0, N
    d1_dev = torch.from_numpy(convert.ints_to_planes(d1, D)).to(dev)
    d2_dev = torch.from_numpy(convert.ints_to_planes(d2, D)).to(dev)
    zero_counts(counted)
    fast = api.scalar_mult_fast(scalars, points)
    fast_strict = api.scalar_mult_fast(scalars, points, strict=True)
    base_strict = api.scalar_mult_base(scalars, strict=True)
    q1x, q1y, ok1 = ecdh.derive_public_planes(d1_dev)
    q2x, q2y, ok2 = ecdh.derive_public_planes(d2_dev)
    q2x_bad, q2y_bad = q2x.clone(), q2y.clone()
    y_off = (convert.planes_to_ints(q2y[:, bad + 2:bad + 3].cpu().numpy())[0] + 1) % P
    q2y_bad[:, bad + 2] = torch.from_numpy(convert.ints_to_planes([y_off], D)[:, 0])
    q2x_bad[:, bad + 3] = torch.from_numpy(convert.ints_to_planes([P], D)[:, 0])
    s12, ok12 = ecdh.shared_secret_planes(d1_dev, q2x_bad, q2y_bad)
    s21, ok21 = ecdh.shared_secret_planes(d2_dev, q1x, q1y)
    torch.cuda.synchronize()
    launches9 = read_counts(counted)
    for k in (comb.KERNEL, comb.KERNEL_STRICT, window.KERNEL, window.KERNEL_STRICT, affine.KERNEL):
        check(launches9[k.symbol] >= 1, f"second main path launched {k.symbol}")

    ones = torch.ones(BATCH, dtype=torch.int32, device=dev)
    want1 = ones.clone()
    want1[bad:bad + 2] = 0
    check(torch.equal(ok1, want1), "derive_public mask: zero scalar and scalar = n rejected")
    check(torch.equal(ok2, ones), "derive_public mask: all valid")
    want12 = ones.clone()
    want12[bad:] = 0
    check(torch.equal(ok12, want12), "shared_secret mask: the four invalid lanes exactly")
    # Q1 on the two bad-scalar lanes is whatever the comb made of 0 and n;
    # the mask must say what an independent on-curve check of it says
    q1_bad = affine_ints(AffinePoint(q1x[:, bad:bad + 2], q1y[:, bad:bad + 2], P256), 2)
    host_ok = [int(x < P and y < P and (x, y) != (0, 0)
                   and (y * y - x**3 - P256.a * x - P256.b) % P == 0) for x, y in q1_bad]
    want21 = ones.clone()
    want21[bad:bad + 2] = torch.tensor(host_ok, dtype=torch.int32)
    check(torch.equal(ok21, want21), "shared_secret mask on the comb's outputs of 0 and n")
    both = (ok12 & ok21).bool()
    check(int(both.sum()) == BATCH - 4, "valid lanes")
    check(torch.equal(s12[:, both], s21[:, both]), "d1*Q2 == d2*Q1 on every valid lane")
    sx = convert.planes_to_ints(s21[:, :MAIN_ORACLE_LANES].cpu().numpy())
    check(sx == [x for x, _ in oracle_base([a * b % N for a, b in zip(d1, d2[:MAIN_ORACLE_LANES])])],
          "shared secrets vs oracle")
    ks = convert.planes_to_ints(s_np[:, :MAIN_ORACLE_LANES])
    bad = window_degenerate_lanes(ks)
    fast_lanes = [i for i in range(len(ks)) if i not in bad]
    check([affine_ints(fast, MAIN_ORACLE_LANES)[i] for i in fast_lanes]
          == [oracle_varbase(ks)[i] for i in fast_lanes], "scalar_mult_fast vs oracle")
    check(affine_ints(fast_strict, MAIN_ORACLE_LANES) == oracle_varbase(ks),
          "scalar_mult_fast(strict) vs oracle")
    check(affine_ints(base_strict, MAIN_ORACLE_LANES) == oracle_base(ks),
          "scalar_mult_base(strict) vs oracle")
    del fast, fast_strict, base_strict, s12, s21

    # the new kernels against their plain versions on the path's own inputs
    # (these launches come after the counts were read)
    window_err, window_plain_ms = {}, {}
    for strict, kname in ((False, "window"), (True, "window_strict")):
        window_plain_ms[kname], plain = time_once_ms(
            lambda: window.window_plain(scalars, points.x, points.y, P256, strict))
        window_err[kname] = max_abs_diff(
            window.window_planes(scalars, points.x, points.y, strict=strict), plain)
        check(window_err[kname] == 0, f"{kname} kernel == window_plain at B = 524,288")
        del plain
    comb_strict_plain_ms, plain = time_once_ms(
        lambda: comb.comb_plain(scalars, tables, P256, negbase, strict=True))
    comb_strict_err = max_abs_diff(
        comb.comb_planes(scalars, mma, negbase_digits, strict=True), plain)
    check(comb_strict_err == 0, "strict comb kernel == strict comb_plain at B = 524,288")
    del plain

    window_ms = time_ms(lambda: window.window_planes(scalars, points.x, points.y), 5)
    window_strict_ms = time_ms(
        lambda: window.window_planes(scalars, points.x, points.y, strict=True), 5)
    comb_strict_ms = time_ms(
        lambda: comb.comb_planes(scalars, mma, negbase_digits, strict=True), 20)
    fast_ms = time_ms(lambda: api.scalar_mult_fast(scalars, points), 5)
    fast_strict_ms = time_ms(lambda: api.scalar_mult_fast(scalars, points, strict=True), 5)
    base_strict_ms = time_ms(lambda: api.scalar_mult_base(scalars, strict=True), 10)
    derive_ms = time_ms(lambda: ecdh.derive_public_planes(d2_dev), 10)
    shared_ms = time_ms(lambda: ecdh.shared_secret_planes(d2_dev, q1x, q1y), 5)
    say(f"phase 9 second main path B={BATCH}: launches {json.dumps(launches9)}; masks exact "
          f"(4 invalid lanes), d1*Q2 == d2*Q1 on {BATCH - 4} lanes, 64 lanes of each result vs "
          f"oracle; E, E strict, B strict exact vs their plain versions; window kernel "
          f"{window_ms:.3f} ms ({rate(window_ms):.0f} mults/s), plain "
          f"{window_plain_ms['window']:.1f} ms; strict {window_strict_ms:.3f} ms, plain "
          f"{window_plain_ms['window_strict']:.1f} ms; strict comb kernel {comb_strict_ms:.3f} ms, "
          f"plain {comb_strict_plain_ms:.1f} ms; "
          f"api.scalar_mult_fast {fast_ms:.3f} ms, strict {fast_strict_ms:.3f} ms; "
          f"api.scalar_mult_base(strict) {base_strict_ms:.3f} ms; ecdh.derive_public_planes "
          f"{derive_ms:.3f} ms ({rate(derive_ms):.0f} keys/s), ecdh.shared_secret_planes "
          f"{shared_ms:.3f} ms ({rate(shared_ms):.0f} secrets/s); plain times at the same shape, "
          f"one run each {card}")

    # -- phase 10: the secp256k1 field (kernel C on the Montgomery field) ------------
    fs_k1 = SECP256K1.field
    pk = fs_k1.p
    a = random_planes(rng, CHECK_LANES)
    b = random_planes(rng, CHECK_LANES)
    pairs = [(x, y) for x in carry_edges(pk) for y in carry_edges(pk)]
    a[:, : len(pairs)] = convert.ints_to_planes([x for x, _ in pairs], D)
    b[:, : len(pairs)] = convert.ints_to_planes([y for _, y in pairs], D)
    a_dev, b_dev = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    got = field_ops.probe(a_dev, b_dev, fs_k1)
    probe_k1_err = max_abs_diff(got, field_ops.probe_plain(a_dev, b_dev, fs_k1))
    check(probe_k1_err == 0, "secp256k1 field probe == plain CIOS GFp")
    ai, bi = convert.planes_to_ints(a[:, :64]), convert.planes_to_ints(b[:, :64])
    ints = [convert.planes_to_ints(got[k, :, :64].cpu().numpy()) for k in range(5)]
    # the planes are Montgomery-form values: the Montgomery oracle's ops
    check(ints[0] == [ofield.mont_mul(x, y, fs_k1) for x, y in zip(ai, bi)],
          "k1 probe mul vs ints")
    check(ints[1] == [ofield.mont_sqr(x, fs_k1) for x in ai], "k1 probe sqr vs ints")
    check(ints[2] == [ofield.mont_add(x, y, fs_k1) for x, y in zip(ai, bi)],
          "k1 probe add vs ints")
    check(ints[3] == [ofield.mont_sub(x, y, fs_k1) for x, y in zip(ai, bi)],
          "k1 probe sub vs ints")
    check(ints[4] == [ofield.mont_opposite(x, fs_k1) for x in ai], "k1 probe opposite vs ints")
    probe_k1_ms = time_ms(lambda: field_ops.probe(a_dev, b_dev, fs_k1), 20)
    probe_k1_plain_ms = time_ms(lambda: field_ops.probe_plain(a_dev, b_dev, fs_k1), 3)
    say(f"phase 10 secp256k1 field probe: {CHECK_LANES} lanes exact vs plain CIOS GFp "
          f"(carry_edges pairs first) and 64 vs "
          f"ints; kernel {probe_k1_ms:.3f} ms, plain {probe_k1_plain_ms:.3f} ms {card}")

    # -- phase 11: the secp256k1 kernels: GLV (F), comb (B), affine (D) -------------
    k1 = SECP256K1
    nk = k1.order
    pp = glv.glv_params(k1)
    lam = pp.lam
    # the lambda class; m lambda (k1 = 0, k2 = m) and small k (k2 = 0)
    glv_edges = [1, 2, lam, lam - 1, lam + 1, nk - 1, nk - 2] + [
        m * lam % nk for m in (3, 5, 6)] + [7, (1 << 100) + 1]
    splits = [glv.split_int(k, pp, nk) for k in glv_edges]
    check([sp[0] for sp in splits[7:10]] == [0, 0, 0] and [sp[2] for sp in splits[10:]] == [0, 0],
          "the edge lanes split with k1 = 0 and with k2 = 0")
    s11_ints = scalar_ints(rng, CHECK_LANES, glv_edges, k1)
    s11 = to_dev(s11_ints, dev)
    pts_k1 = varbase_points(CHECK_LANES, dev, k1)
    xm = GFp.from_classical(pts_k1.x, fs_k1).planes.contiguous()
    ym = GFp.from_classical(pts_k1.y, fs_k1).planes.contiguous()
    packed11 = kglv.pack_scalars(s11, k1)
    glv_check, glv_plain_check_ms = {}, {}
    for strict, kname in ((False, "glv"), (True, "glv_strict")):
        got = kglv.glv_planes(packed11, xm, ym, k1, strict=strict)
        glv_plain_check_ms[kname], want = time_once_ms(
            lambda: kglv.glv_plain(packed11, xm, ym, k1, strict))
        glv_check[kname] = max_abs_diff(got, want)
        check(glv_check[kname] == 0, f"{kname} kernel == glv_plain (Jacobian)")
        del want
        if strict:
            check(jacobian_affine_ints(got, ORACLE_LANES, k1)
                  == oracle_varbase(s11_ints[:ORACLE_LANES], k1), "glv_strict vs oracle")
    say(f"phase 11 glv: F and F strict {CHECK_LANES} lanes exact vs glv_plain "
          f"({glv_plain_check_ms['glv']:.1f} / {glv_plain_check_ms['glv_strict']:.1f} ms plain); "
          f"strict {ORACLE_LANES} lanes with points (i+1)G vs oracle (1, 2, lambda, lambda +- 1, "
          f"n-1, n-2, k1 = 0 and k2 = 0 splits)")

    tables_k1, negbase_k1, nb_k1 = comb.device_tables(k1, k1.gx, k1.gy, dev)
    mma_k1 = comb.mma_tables(k1, k1.gx, k1.gy, dev)
    comb_k1_check = {}
    for strict, kname in ((False, "comb_secp256k1"), (True, "comb_strict_secp256k1")):
        edges = [1, 2, 5, nk - 2] + ([nk - 1] if strict else [])
        s_ints = scalar_ints(rng, CHECK_LANES, edges, k1)
        s_k1 = to_dev(s_ints, dev)
        got = comb.comb_planes(s_k1, mma_k1, nb_k1, k1, strict=strict)
        comb_k1_check[kname] = max_abs_diff(
            got, comb.comb_plain(s_k1, tables_k1, k1, negbase_k1, strict))
        check(comb_k1_check[kname] == 0, f"{kname} kernel == comb_plain (Jacobian)")
        check(jacobian_affine_ints(got, ORACLE_LANES, k1)
              == oracle_base(s_ints[:ORACLE_LANES], k1), f"{kname} vs oracle")
        comb_k1_got, comb_k1_ints = got, s_ints
    jx, jy, jz = affine_edge_input(comb_k1_got, k1)
    got = affine.affine_planes(jx, jy, jz, k1)
    plain = JacobianPoint(*(GFp(t, fs_k1) for t in (jx, jy, jz)), k1).to_affine()
    affine_k1_check = max_abs_diff(got, (plain.x, plain.y))
    check(affine_k1_check == 0, "secp256k1 affine kernel == JacobianPoint.to_affine")
    affine_edge_check(got, (jx, jy, jz), k1, "secp256k1 affine")
    check(affine_ints(AffinePoint(*got, k1), ORACLE_LANES)
          == oracle_base(comb_k1_ints[:ORACLE_LANES], k1), "secp256k1 affine vs oracle")
    del got, plain, jx, jy, jz, comb_k1_got
    say(f"phase 11 comb, comb_strict, affine on secp256k1: {CHECK_LANES} lanes exact vs "
          f"comb_plain / to_affine (lanes at infinity at group edges; a ragged batch); "
          f"{ORACLE_LANES} lanes vs oracle (edge scalars 1, 2, 5, n-2; n-1 strict)")

    # -- phase 12: the third main path, batched ECDSA, on both curves ----------------
    path12 = {c.name: ecdsa_path(rng, dev, card, counted, c) for c in (P256, SECP256K1)}
    launches12 = sum_counts([c["launches"] for c in path12.values()])

    # the secp256k1 kernels against their plain versions on the path's own
    # inputs (these launches come after the counts were read)
    pk1 = path12[SECP256K1.name]
    glv_strict_plain_ms, plain = time_once_ms(
        lambda: kglv.glv_plain(pk1["packed"], pk1["qxm"], pk1["qym"], SECP256K1, True))
    glv_strict_err = max_abs_diff(
        kglv.glv_planes(pk1["packed"], pk1["qxm"], pk1["qym"], SECP256K1, strict=True), plain)
    check(glv_strict_err == 0, "glv_strict kernel == glv_plain at B = 524,288")
    del plain
    comb_k1_plain_ms, plain = time_once_ms(
        lambda: comb.comb_plain(pk1["d"], tables_k1, SECP256K1, negbase_k1))
    comb_k1_err = max_abs_diff(pk1["jac"], plain)
    check(comb_k1_err == 0, "secp256k1 comb kernel == comb_plain at B = 524,288")
    affine_k1_plain_ms, plain = time_once_ms(
        lambda: JacobianPoint(*(GFp(t, fs_k1) for t in pk1["jac"]), SECP256K1).to_affine())
    affine_k1_err = max_abs_diff(affine.affine_planes(*pk1["jac"], SECP256K1), (plain.x, plain.y))
    check(affine_k1_err == 0, "secp256k1 affine kernel == to_affine at B = 524,288")
    affine_large_check(pk1["jac"], SECP256K1, "secp256k1 affine")
    del plain
    comb_k1_strict_ms = time_ms(
        lambda: comb.comb_planes(pk1["d"], mma_k1, nb_k1, SECP256K1, strict=True), 10)
    comb_k1_strict_plain_ms, plain = time_once_ms(
        lambda: comb.comb_plain(pk1["d"], tables_k1, SECP256K1, negbase_k1, strict=True))
    comb_k1_strict_err = max_abs_diff(
        comb.comb_planes(pk1["d"], mma_k1, nb_k1, SECP256K1, strict=True), plain)
    check(comb_k1_strict_err == 0, "secp256k1 strict comb kernel == comb_plain at B = 524,288")
    del plain
    glv_ms = time_ms(lambda: kglv.glv_planes(packed11, xm, ym, k1, strict=False), 5)
    say(f"phase 12 secp256k1 kernels exact vs their plain versions at B = {ECDSA_BATCH}: "
          f"glv_strict plain {glv_strict_plain_ms:.1f} ms, comb plain {comb_k1_plain_ms:.1f} ms, "
          f"strict comb {comb_k1_strict_ms:.3f} ms (plain {comb_k1_strict_plain_ms:.1f} ms), "
          f"affine plain {affine_k1_plain_ms:.1f} ms; glv (plain chain) {glv_ms:.3f} ms at "
          f"{CHECK_LANES} lanes {card}")

    xp = x25519_phases(rng, dev, card, counted)
    sp = schedule_phase(rng, dev, card, counted, scalars, comb_plain_ms)
    b9 = general_phase(rng, dev, card, counted, scalars)
    p18 = {c: curve_phase(rng, dev, card, counted, c) for c in CURVES18}
    launches18 = sum_counts([p["launches"] for p in p18.values()])
    p19 = {c: wide_phase(rng, dev, card, counted, c) for c in CURVES19}
    p20 = {c: wide_schedule_phase(rng, dev, card, counted, c) for c in CURVES19}
    p21 = {c: msm_phase(rng, dev, card, counted, c) for c in _build.CURVES}
    sass_mix = sass_job.result()
    for kname, mix in sass_mix.items():
        check(mix is not None, f"cuobjdump -sass found {kname}")
    say("phase 1 SASS of kernels E (five curves), F, B and L (five curves, chains 2, "
        "unroll 1), A, D, J and K (five curves), G and H, M (five curves: a trip of its lane "
        "loop, one output lane), instructions a lane issues by class "
        "(cuobjdump -sass, loop bodies times their runs, called functions times their calls): "
        + json.dumps({k: v["per_lane"] for k, v in sass_mix.items()}) + "; the called "
        "functions, once each (multiply, then squaring): " + json.dumps(
            {k: [c["static"] for c in v["callees"]] for k, v in sass_mix.items()
             if v["callees"]}))
    for kname in sass.WIDE_KERNELS:
        # the scratch is written and read by the same thread: never the
        # read-only path (the inputs' 32-bit loads may take it)
        mix = sass_mix[kname]["static"]
        check(mix.get("ldg128", 0) > 0 and mix.get("ldg128_nc", 0) == 0,
              f"{kname} reads its scratch with 16-byte ld.global, not the read-only path")
    for kname in sass.LADDER_KERNELS + ("mladder_w25519_kernel",):
        check(sass_mix[kname]["per_lane"] is not None,
              f"{kname}'s loops are the scalar's words by their bits")
    for kname in sass.COMB_KERNELS + sass.TREE_PIPE_KERNELS:
        # B, J, K and L select on the tensor cores: IMMA, and no
        # scan loop over a position's entries (their loop nests are TRIPS')
        mix = sass_mix[kname]
        check(mix["static"].get("imma", 0) > 0 and mix["static"].get("lds128", 0) == 0
              and mix["per_lane"] is not None,
              f"{kname} selects with IMMA and scans no position with 16-byte loads")
    for kname in sass.BATCH_SUM_KERNELS:
        # kernel M reads what its earlier levels wrote in the same launch:
        # never through the read-only path
        mix = sass_mix[kname]
        check(mix["static"].get("ldg_nc", 0) == 0 and mix["per_lane"] is not None,
              f"{kname}: no read-only loads, and its lane loop found")
    launches19 = sum_counts([p["launches"] for p in p19.values()])
    paths = {"phase6": launches6, "phase9": launches9, "phase12": launches12,
             "phase15": xp["launches15"], "phase16": xp["launches16"],
             "phase17": sp["launches17"], "phase18": launches18, "phase19": launches19}
    # phase 17's B9 part and phase 20: a path a curve
    paths |= {f"phase17_b9_{_build.CURVE_TAGS[c][0]}": p["launches"] for c, p in b9.items()}
    paths |= {f"phase20_{_build.CURVE_TAGS[c][0]}": p["launches"] for c, p in p20.items()}
    paths |= {f"phase21_{_build.CURVE_TAGS[c][0]}": p["launches"] for c, p in p21.items()}

    def entry(kernel, kname, err, ms, plain_ms, lanes=BATCH, reps=0, schedule=None):
        """One kernel of the kernels line: its launches on the main paths
        (L's at ``schedule`` only), by path with the lanes of
        each, and weighted by lanes (launches of ``lanes`` lanes that do
        the same work), beside its times at ``lanes``."""
        bound_ms, bound_by = bound(kname, lanes, sm_clock_mhz, reps)
        ints = None
        if schedule is not None and kernel.n_ints == 2:  # L: count its schedule
            ints = (schedule.get("chains", 1), schedule.get("unroll", 1))
        by_path = {}
        for path, counts in paths.items():
            by_lanes = {}
            for (n_lanes, *k_ints), n in counts.shapes.get(kernel.symbol, {}).items():
                if ints is None or tuple(k_ints) == ints:
                    by_lanes[n_lanes] = by_lanes.get(n_lanes, 0) + n
            if by_lanes:
                by_path[path] = {"launches": sum(by_lanes.values()), "lanes": by_lanes}
        weighted = sum(n * n_lanes for p in by_path.values() for n_lanes, n in p["lanes"].items())
        return {
            "name": kname, "route": "cuda", "source": kernel.source, "replaces": kernel.replaces,
            "launches": sum(p["launches"] for p in by_path.values()),
            "launches_by_path": by_path, "lane_weighted_launches": weighted / lanes,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "lanes": lanes,
            **res[kname], **dynamic_smem(kernel), **table_split(kernel, dev),
        }

    ms_k1 = pk1["ms"]
    kernels = [
        entry(comb.KERNEL, "comb", max(comb_err, comb_check_err), comb_ms, comb_plain_ms),
        entry(comb.KERNEL_STRICT, "comb_strict", max(comb_strict_err, comb_strict_check_err),
              comb_strict_ms, comb_strict_plain_ms),
        entry(comb.KERNEL_SECP256K1, "comb_secp256k1",
              max(comb_k1_err, comb_k1_check["comb_secp256k1"]), ms_k1["kernel_comb"],
              comb_k1_plain_ms, lanes=ECDSA_BATCH),
        entry(comb.KERNEL_SECP256K1_STRICT, "comb_strict_secp256k1",
              max(comb_k1_strict_err, comb_k1_check["comb_strict_secp256k1"]), comb_k1_strict_ms,
              comb_k1_strict_plain_ms, lanes=ECDSA_BATCH),
        entry(ladder.KERNEL, "ladder", ladder_err, ladder_ms, ladder_plain_ms),
        *(entry(k, kname, max(window_err[kname], window_check[kname]), ms,
                window_plain_ms[kname])
          for k, kname, ms in ((window.KERNEL, "window", window_ms),
                               (window.KERNEL_STRICT, "window_strict", window_strict_ms))),
        entry(kglv.KERNEL, "glv", glv_check["glv"], glv_ms, glv_plain_check_ms["glv"],
              lanes=CHECK_LANES),
        entry(kglv.KERNEL_STRICT, "glv_strict", max(glv_strict_err, glv_check["glv_strict"]),
              ms_k1["kernel_glv_strict"], glv_strict_plain_ms, lanes=ECDSA_BATCH),
        entry(affine.KERNEL, "affine", max(affine_err, affine_check_err), affine_ms,
              affine_plain_ms),
        entry(affine.KERNEL_SECP256K1, "affine_secp256k1", max(affine_k1_err, affine_k1_check),
              ms_k1["kernel_affine"], affine_k1_plain_ms, lanes=ECDSA_BATCH),
        entry(field_ops.KERNEL, "field_probe", probe_err, probe_ms, probe_plain_ms,
              lanes=CHECK_LANES),
        entry(field_ops.KERNEL_SECP256K1, "field_probe_secp256k1", probe_k1_err, probe_k1_ms,
              probe_k1_plain_ms, lanes=CHECK_LANES),
        entry(mladder.KERNEL, "mladder", max(xp["mladder_err"], xp["mladder_check_err"]),
              xp["mladder_ms"], xp["mladder_plain_ms"]),
        entry(mladder.KERNEL_XDIVZ, "x25519_xdivz", max(xp["xdivz_err"], xp["xdivz_check_err"]),
              xp["xdivz_ms"], xp["xdivz_plain_ms"]),
        entry(comb.KERNEL_W25519, "comb_w25519", max(xp["comb_err"], xp["comb_check_err"]),
              xp["comb_ms"], xp["comb_plain_ms"]),
        entry(affine.KERNEL_W25519, "affine_w25519", max(xp["affine_err"], xp["affine_check_err"]),
              xp["affine_ms"], xp["affine_plain_ms"]),
        entry(field_ops.KERNEL_W25519, "field_probe_w25519", xp["probe_err"], xp["probe_ms"],
              xp["probe_plain_ms"], lanes=CHECK_LANES),
        # ms and bound at the ceiling measurement's CALIB_REPS; plain_ms at
        # CALIB_CHECK_REPS on the same elements (the plain chains take
        # ~10^2 launches a step)
        {**entry(roofline.KERNEL, "calib", xp["calib_err"], xp["ceiling"]["ms_per_launch"],
                 xp["calib_plain_ms"], lanes=xp["calib_elements"], reps=CALIB_REPS),
         "reps": CALIB_REPS, "plain_reps": CALIB_CHECK_REPS},
        # phases 17 and 18: kernel L's launches at its schedule, its staged
        # positions a step and shared memory at that schedule
        *({**entry(sp["kernels"][k], k, max(v["err"], v["check_err"]), v["ms"], v["plain_ms"],
                   schedule=SCHEDULES[k]),
           **{x: v[x] for x in ("group", "dynamic_smem_bytes", "blocks_per_sm") if x in v}}
          for k, v in sp["by_kernel"].items()),
        *({**entry(p["kernels"][k], k, v["err"], v["ms"], v["plain_ms"],
                   schedule=SCHEDULES.get(k.rsplit("_", 1)[0])),
           **{x: v[x] for x in ("plain_lanes", "group", "dynamic_smem_bytes", "blocks_per_sm")
              if x in v}}
          for p in p18.values() for k, v in p["by_kernel"].items()),
        # phase 19: ms and bound at B (kernel C at CHECK_LANES), plain_ms on
        # the path's first plain_lanes lanes
        *({**entry(p["kernels"][k], k, v["err"], v["ms"], v["plain_ms"],
                   lanes=v.get("lanes", BATCH)), "plain_lanes": v["plain_lanes"]}
          for p in p19.values() for k, v in p["by_kernel"].items()),
        # phase 17's B9 part and phase 20: one entry a (kernel, curve,
        # schedule); ms and bound at B, plain_ms on the path's first
        # plain_lanes lanes; kernel L's staged positions a step
        # (group) and shared memory at that schedule
        *({**entry(p["kernels"][k], k, v["err"], v["ms"], v["plain_ms"],
                   schedule=v.get("schedule")),
           **{x: v[x] for x in ("plain_lanes", "schedule", "group", "dynamic_smem_bytes",
                                "blocks_per_sm") if x in v}}
          for p in (*b9.values(), *p20.values()) for k, v in p["by_kernel"].items()),
        # phase 21: kernel M, ms and bound over a whole tree of B lanes (one
        # launch), plain_ms the plain batch sum's on the same lanes; launches
        # counted over both sums of the path; the depth floor: ceil(log2 B)
        # times one level's latency, the slope over trees of 2^k lanes of the
        # CUDA events of lone calls, each one launch (depth_floor_from)
        *({**entry(p["kernel"], p["name"], p["err"], p["ms"], p["plain_ms"]),
           "launches_per_sum": 1, "ms_runs": p["ms_runs"], "threads": p["threads"],
           "handoff_sizes": p["handoff_sizes"], "first_level_ms": p["level_ms"],
           "first_level_plain_ms": p["level_plain_ms"],
           "depth_floor_ms": p["depth_floor"]["depth_floor_ms"],
           "depth_floor_from": p["depth_floor"]["depth_floor_from"],
           "level_latency_ms": p["depth_floor"]["event_slope_ms"]} for p in p21.values()),
    ]
    api_ms = {"scalar_mult_base": base_api_ms, "scalar_mult": var_api_ms,
              "scalar_mult_fast": fast_ms, "scalar_mult_fast_strict": fast_strict_ms,
              "scalar_mult_base_strict": base_strict_ms,
              "ecdh.derive_public_planes": derive_ms, "ecdh.shared_secret_planes": shared_ms,
              **{f"ecdsa.{c}.{k}": v for c, pth in path12.items() for k, v in pth["ms"].items()},
              "x25519.x25519_planes": xp["x25519_planes_ms"],
              "x25519.derive_public_planes": xp["derive_public_planes_ms"],
              **{f"comb.scalar_mult_base({schedule_args(k)}) + affine": v["api_ms"]
                 for k, v in sp["by_kernel"].items()},
              **{k: v for p in p18.values() for k, v in p["api_ms"].items()},
              **{k: v for p in p19.values() for k, v in p["api_ms"].items()},
              **{k: v for p in (*b9.values(), *p20.values(), *p21.values())
                 for k, v in p["api_ms"].items()}}
    # the measured int32 rate against the 64 IMAD per SM per clock bound()
    # assumes: kernel I issues 2 of its 4 instructions a chain step on the
    # multiply-add pipe (IMAD, IMAD.IADD), so that pipe's rate is 2 / 5 of
    # the int32 operations' (40 per 8-chain step)
    assumed = IMAD_PER_SM_PER_CLOCK * SMS * sm_clock_mhz * 1e6
    imad_pipe = xp["ceiling"]["int32_ops_per_s"] * 2 / 5
    ceiling = {**xp["ceiling"], "assumed_imad_per_s": assumed, "imad_pipe_per_s": imad_pipe,
               "imad_pipe_ratio": imad_pipe / assumed,
               "int32_ops_ratio": xp["ceiling"]["int32_ops_per_s"] / assumed}
    print(f"int32 ceiling: measured {ceiling['int32_ops_per_s']:.4e} int32 ops/s "
          f"({ceiling['imad_per_s']:.4e} multiplies/s, {imad_pipe:.4e} multiply-add-pipe "
          f"instructions/s) against the assumed {assumed:.4e} IMAD/s (64 per SM per clock x {SMS} "
          f"SMs x {sm_clock_mhz:.0f} MHz): multiply-add pipe at {ceiling['imad_pipe_ratio']:.4f} "
          f"of it, int32 operations at {ceiling['int32_ops_ratio']:.4f} {card}", flush=True)
    print(json.dumps({"kernels": kernels, "card": smi,
                      "sm_clock_max_mhz": sm_clock_mhz, "batch": BATCH,
                      "build_s": build.seconds, "api_ms": api_ms, "int32_ceiling": ceiling,
                      "wall_s": time.perf_counter() - t_start}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
