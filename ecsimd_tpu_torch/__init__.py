"""ecsimd_tpu_torch — batched elliptic-curve arithmetic on PyTorch and CUDA.

The PyTorch port of ``ecsimd_tpu``, for NVIDIA Hopper cards. It keeps the JAX
package's interface — (D, B) int32 planes of base-2^16 digits, digit axis
leading, batch axis trailing — so every result compares bit-for-bit with the
JAX package and its Python-int oracle, and it keeps the JAX package's module
names so that each module's counterpart is easy to find.

Layer map:
  specs, convert, oracle  the port's own copies of the JAX package's
                          framework-free modules (the port imports nothing
                          of ecsimd_tpu; tests hold the copies to it)
  ops.bignum / ops.mont   digit-plane carry add/sub, products, compares,
                          selects; CIOS Montgomery multiplication
  ops.solinas             multiply-free Solinas reduction (P-256)
  ops.crandall            the Crandall fold (2^255 - 19, P-521)
  field.GFp               prime-field value type (Solinas, Crandall and
                          Montgomery fields), inversion, square roots
  curves.point / group    points, the co-Z group law, Jacobian doubling,
                          general and complete adds, decompression; plain
                          ladder
  glv                     the GLV endomorphism split (secp256k1)
  kernels                 hand-written CUDA kernels for sm_90a (csrc/) and
                          their wrappers: comb (k*G, P-256 and secp256k1,
                          plain and strict; Wei25519), ladder, signed window
                          and GLV (k*P), the x-only ladder and x / z
                          (X25519), affine conversion, field probe;
                          glv.strict_varbase routes
  api, ecdh, ecdsa        batched scalar-multiplication entry points, ECDH,
                          ECDSA sign / verify / recover
  x25519                  RFC 7748 X25519 exchange and keygen
  bench.roofline          the int32 throughput calibration of the card

Every public function runs on the device of its input tensors: a CUDA tensor
goes through the CUDA kernel, a CPU tensor through the kernel's plain PyTorch
version. Constructors that make tensors from ints default to the card
(``device="cuda"``) and raise where there is none; the CPU is used only
when the caller asks for it.
"""

from ecsimd_tpu_torch.specs import (
    CURVES,
    DIGIT_BITS,
    FIELDS,
    P256,
    P256_FIELD,
    P384,
    P521,
    P521_FIELD,
    SECP256K1,
    SECP256K1_FIELD,
    W25519_FIELD,
    WEI25519,
    CurveSpec,
    FieldSpec,
)

__version__ = "0.1.0"

__all__ = [
    "CURVES",
    "DIGIT_BITS",
    "FIELDS",
    "P256",
    "P256_FIELD",
    "P384",
    "P521",
    "P521_FIELD",
    "SECP256K1",
    "SECP256K1_FIELD",
    "W25519_FIELD",
    "WEI25519",
    "CurveSpec",
    "FieldSpec",
    "__version__",
]
