"""ecsimd_tpu_torch — batched elliptic-curve arithmetic on PyTorch and CUDA.

The PyTorch port of ``ecsimd_tpu``, for NVIDIA Hopper cards. It keeps the JAX
package's interface — (D, B) int32 planes of base-2^16 digits, digit axis
leading, batch axis trailing — so every result compares bit-for-bit with the
JAX package and its Python-int oracle, and it keeps the JAX package's module
names so that each module's counterpart is easy to find.

Layer map:
  specs, convert, oracle  shared with ecsimd_tpu by import (they use no JAX)
  ops.bignum / ops.mont   digit-plane carry add/sub, selects, product columns
  ops.solinas             multiply-free Solinas reduction (P-256)
  field.GFp               prime-field value type (plain Solinas fields)
  curves.point / group    points and the co-Z group law; plain ladder
  kernels                 hand-written CUDA kernels for sm_90a (csrc/) and
                          their wrappers: comb (k*G), ladder (k*P), affine
                          conversion, field probe
  api                     batched scalar-multiplication entry points

Every public function runs on the device of its input tensors: a CUDA tensor
goes through the CUDA kernel, a CPU tensor through the kernel's plain PyTorch
version.
"""

from ecsimd_tpu.specs import (
    CURVES,
    DIGIT_BITS,
    FIELDS,
    P256,
    P256_FIELD,
    P384,
    SECP256K1_FIELD,
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
    "SECP256K1_FIELD",
    "CurveSpec",
    "FieldSpec",
    "__version__",
]
