"""Pure-Python arbitrary-precision oracle.

The port's own copy of the parts of ``ecsimd_tpu/oracle`` that it calls
(``coz``, ``field``, ``window``), so that the port and ``chip_smoke.py`` import nothing
of the JAX package; ``tests/test_torch_specs.py`` holds it to the original.
``comb`` composes the comb's schedules from them on Python ints.

Plays the role ctbignum plays for the reference (scalar differential oracle in
tests, ``tests/mgry.cpp:52-76``) and of the ``work/`` Python prototypes
(algorithm-level validation, ``work/coz.py``, ``work/coz_swap.py``): every
kernel must agree bit-exactly with these functions.
"""
