"""Host-side correctness oracle: exact bigint field, curve and MSM code.

The port's own copy of the JAX package's oracle, with the same names.
"""
from .field import (  # noqa: F401
    P,
    EDWARDS_A,
    EDWARDS_D,
    SUBGROUP_ORDER,
    R_MOD_P,
    R2_MOD_P,
    N0_INV_16,
    N0_INV_32,
    fadd,
    fsub,
    fmul,
    fneg,
    finv,
    fsqrt,
    to_mont,
    from_mont,
)
from .curve import (  # noqa: F401
    ExtPoint,
    IDENTITY,
    add,
    double,
    neg,
    scalar_mul,
    from_affine,
    to_affine,
    is_on_curve,
    eq,
)
from . import msm  # noqa: F401  (submodule; use oracle.msm.msm(...))
from .msm import msm_naive, split_scalar, n_windows  # noqa: F401
