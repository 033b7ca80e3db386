"""Bit-exact ports of the reference's fast float math.

Port of mmseqs2_tpu/profile/mathx.py.
flog2/fpow2 (reference src/commons/MathUtil.h:107-146) are polynomial
approximations over exponent/mantissa bit manipulation — the PSSM pipeline's
Neff values depend on their exact rounding, so we reproduce them bit-for-bit
with numpy float32/int32 views.
"""

import numpy as np


def flog2(x):
    # the reference's polynomial constants are DOUBLE literals (no f suffix,
    # MathUtil.h:107-119): the polynomial evaluates in float64 and only the
    # final `x *= poly` product is narrowed back to float32
    x = np.asarray(x, dtype=np.float32)
    nonpos = x <= 0
    xi = np.where(nonpos, np.float32(1.0), x).view(np.int32)
    e = (((xi & 0x7F800000) >> 23) - 0x7F).astype(np.float32)
    m = ((xi & 0x007FFFFF) | 0x3F800000).view(np.float32)
    t = (m - np.float32(1.0)).astype(np.float64)
    poly = 1.441740 + t * (
        -0.7077702 + t * (0.4123442 + t * (-0.1903190 + t * 0.0440047)))
    res = (t * poly).astype(np.float32) + e
    return np.where(nonpos, np.float32(-128.0), res).astype(np.float32)


def fpow2(x):
    x = np.asarray(x, dtype=np.float32)
    hi = x >= np.float32(128)          # FLT_MAX_EXP
    lo = x <= np.float32(-125)         # FLT_MIN_EXP
    xs = np.where(hi | lo, np.float32(0.0), x)
    tx = (xs - np.float32(0.5)) + np.float32(3 << 22)
    lx = tx.view(np.int32) - 0x4B400000
    dx = xs - lx.astype(np.float32)
    y = np.float32(1.0) + dx * (np.float32(0.693019) + dx * (
        np.float32(0.241404) + dx * (
            np.float32(0.0520749) + dx * np.float32(0.0134929))))
    yi = y.view(np.int32) + (lx << 23)
    res = yi.view(np.float32)
    res = np.where(hi, np.float32(np.finfo(np.float32).max), res)
    res = np.where(lo, np.float32(0.0), res)
    return res.astype(np.float32)


def convert_neff_to_char(neff):
    v = np.minimum(np.float32(255.0),
                   np.float32(1.0) + np.float32(64.0) * flog2(neff))
    # the reference's float->uchar cast is UB for negatives (Neff 0 at an
    # all-X leading column); the compiled binary lands on the max(1, ...)
    # floor, so clamp below 1 explicitly
    v = np.maximum(v, np.float32(0.5))
    c = (v + np.float32(0.5)).astype(np.uint8)
    return np.maximum(np.uint8(1), c)
