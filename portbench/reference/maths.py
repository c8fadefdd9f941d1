"""Frozen copy of the port's float32 maths that the plain step needs.

Copied from ``flygym_tpu_torch/engine/maths.py`` (glibc's ``sinf``,
``cosf`` and ``powf`` algorithms, ``sqrt_rn``, the quaternion helpers),
without the autograd wrappers: the reference only runs forward. Later
edits to the port do not move it.
"""

import struct

import numpy as np
import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product of (..., 3) vectors, broadcasting like ``jnp.cross``."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# float32 sin and cos as the JAX package's CPU backend rounds them
# ---------------------------------------------------------------------------
# XLA's CPU backend takes sin and cos of float32 from glibc's sinf/cosf
# (sysdeps/ieee754/flt-32/s_sinf.c, s_cosf.c, sincosf.h): a float64 range
# reduction by pi/2 and a float64 polynomial, rounded to float32. torch.sin
# rounds otherwise in ~5% of arguments on the CPU (CUDA's sinf is another
# algorithm again), and those 1-ulp differences, amplified by the contact
# solve, flip line-search brackets within tens of steps. The engine, the
# plain mega-step emitter and K2 (ms_sinf/ms_cosf in csrc/megastep.cu) all
# use this algorithm, so they repeat the JAX package's rounding (checked
# against libm for |x| <= 4 on 3e7 arguments).

_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")  # 2/pi * 2^24
_HPI = float.fromhex("0x1.921FB54442D18p0")  # pi/2
_COS_C = [1.0] + [float.fromhex(h) for h in (
    "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5", "-0x1.6c087e89a359dp-10",
    "0x1.99343027bf8c3p-16")]
_SIN_S = [float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13")]


def _top12(x: float) -> int:
    return (int(np.float32(x).view(np.int32)) >> 20) & 0x7FF


_TOP_TINY, _TOP_PIO4, _TOP_BIG = _top12(2.0**-12), _top12(float.fromhex("0x1.921FB6p-1")), _top12(120.0)


def _sincos_poly(x, x2, odd):
    """glibc's sinf_poly: the sine polynomial where ``odd`` is false, the
    cosine polynomial where it is true (float64)."""
    x3 = x * x2
    s = x + x3 * _SIN_S[0]
    sin_p = s + (x3 * x2) * (_SIN_S[1] + x2 * _SIN_S[2])
    x4 = x2 * x2
    c = (_COS_C[0] + x2 * _COS_C[1]) + x4 * _COS_C[2]
    cos_p = c + (x4 * x2) * (_COS_C[3] + x2 * _COS_C[4])
    return torch.where(odd, cos_p, sin_p)


def _sincosf(y: torch.Tensor, cos: bool) -> torch.Tensor:
    """sinf(y) or cosf(y) of a float32 tensor, rounded as glibc rounds them.
    Arguments of 120 or more in magnitude (glibc's slow reduction; joint
    angles never get there) take float64 sin/cos rounded to float32."""
    x = y.double()
    top = (y.view(torch.int32) >> 20) & 0x7FF
    n = ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    xr = x - n.double() * _HPI
    sign = torch.where(((n & 3) == 1) | ((n & 3) == 2), -1.0, 1.0).double()
    small = top < _TOP_PIO4
    nq = torch.where(small, 0, n) ^ int(cos)
    odd = (nq & 1) == 1
    out = _sincos_poly(torch.where(small, x, xr * sign), torch.where(small, x * x, xr * xr), odd)
    out = torch.where(~small & ((n & 2) == 2) & odd, -out, out).float()
    far = torch.cos(x) if cos else torch.sin(x)
    out = torch.where(top < _TOP_BIG, out, far.float())
    return torch.where(top < _TOP_TINY, torch.ones_like(y) if cos else y, out)


def sinf(y: torch.Tensor) -> torch.Tensor:
    """sin of a float32 tensor, rounded as glibc's sinf rounds it."""
    return _sincosf(y, False)


def cosf(y: torch.Tensor) -> torch.Tensor:
    """cos of a float32 tensor, rounded as glibc's cosf rounds it."""
    return _sincosf(y, True)



# ---------------------------------------------------------------------------
# float32 pow as the JAX package's CPU backend rounds it
# ---------------------------------------------------------------------------
# XLA's CPU backend takes pow of float32 (jnp.power with a float exponent)
# from glibc's powf (sysdeps/ieee754/flt-32/e_powf.c): log2(x) from a
# 16-entry table and a float64 polynomial, times y, then exp2 from a
# 32-entry table and a float64 polynomial, rounded to float32. It is not
# correctly rounded (~0.04% of arguments differ from x^3 rounded once), and
# x*x*x differs from it in a quarter of arguments. The contact impedance's
# pow (engine and plain mega-step emitter here, ms_powf in
# csrc/megastep.cu) repeats this algorithm, with its table values (checked
# against libm on 8e7 arguments).

_POWF_INVC = [float.fromhex(h) for h in (
    "0x1.661ec79f8f3bep+0", "0x1.571ed4aaf883dp+0", "0x1.49539f0f010b0p+0",
    "0x1.3c995b0b80385p+0", "0x1.30d190c8864a5p+0", "0x1.25e227b0b8ea0p+0",
    "0x1.1bb4a4a1a343fp+0", "0x1.12358f08ae5bap+0", "0x1.0953f419900a7p+0",
    "0x1.0000000000000p+0", "0x1.e608cfd9a47acp-1", "0x1.ca4b31f026aa0p-1",
    "0x1.b2036576afce6p-1", "0x1.9c2d163a1aa2dp-1", "0x1.886e6037841edp-1",
    "0x1.767dcf5534862p-1")]
_POWF_LOGC = [float.fromhex(h) for h in (
    "-0x1.efec65b963019p-2", "-0x1.b0b6832d4fca4p-2", "-0x1.7418b0a1fb77bp-2",
    "-0x1.39de91a6dcf7bp-2", "-0x1.01d9bf3f2b631p-2", "-0x1.97c1d1b3b7af0p-3",
    "-0x1.2f9e393af3c9fp-3", "-0x1.960cbbf788d5cp-4", "-0x1.a6f9db6475fcep-5",
    "0x0.0p+0", "0x1.338ca9f24f53dp-4", "0x1.476a9543891bap-3",
    "0x1.e840b4ac4e4d2p-3", "0x1.40645f0c6651cp-2", "0x1.88e9c2c1b9ff8p-2",
    "0x1.ce0a44eb17bccp-2")]
_POWF_A = [float.fromhex(h) for h in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0")]
# 2^(i/32) as float64 bits, minus i << 47 (glibc's __exp2f_data.tab).
_EXP2F_TAB = [int(h, 16) for h in (
    "3ff0000000000000", "3fefd9b0d3158574", "3fefb5586cf9890f", "3fef9301d0125b51",
    "3fef72b83c7d517b", "3fef54873168b9aa", "3fef387a6e756238", "3fef1e9df51fdee1",
    "3fef06fe0a31b715", "3feef1a7373aa9cb", "3feedea64c123422", "3feece086061892d",
    "3feebfdad5362a27", "3feeb42b569d4f82", "3feeab07dd485429", "3feea47eb03a5585",
    "3feea09e667f3bcd", "3fee9f75e8ec5f74", "3feea11473eb0187", "3feea589994cce13",
    "3feeace5422aa0db", "3feeb737b0cdc5e5", "3feec49182a3f090", "3feed503b23e255d",
    "3feee89f995ad3ad", "3feeff76f2fb5e47", "3fef199bdd85529c", "3fef3720dcef9069",
    "3fef5818dcfba487", "3fef7c97337b9b5f", "3fefa4afa2a490da", "3fefd0765b6e4540")]
_EXP2F_C = [float.fromhex(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1")]
_EXP2F_SHIFT = float.fromhex("0x1.8p52") / 32
# The tables above on each device they were asked for: a copy from the host
# at every call would wait for the card's queue to drain.
_POWF_TABLES = {}


def _powf_tables(dev) -> tuple:
    tables = _POWF_TABLES.get(dev)
    if tables is None:
        tables = _POWF_TABLES[dev] = (
            torch.tensor(_POWF_INVC, dtype=torch.float64, device=dev),
            torch.tensor(_POWF_LOGC, dtype=torch.float64, device=dev),
            torch.tensor(_EXP2F_TAB, dtype=torch.int64, device=dev))
    return tables


_powf_tables(torch.device("cpu"))  # so that no CPU call makes them (or counts them)


def _f32(v: float) -> float:
    """``v`` rounded to the nearest float32."""
    return struct.unpack("f", struct.pack("f", v))[0]



def powf(x: torch.Tensor, y) -> torch.Tensor:
    """x ** y rounded as glibc's powf rounds it (a Python exponent is
    rounded to float32 first, as ``jnp.power`` does)."""
    return _powf(x, y if isinstance(y, torch.Tensor) else _f32(y))



# glibc's subnormal x: the bits of x * 2^23 (0 under denormals-are-zero)
# less 23 << 23, as an int32; its log2 comes out as exactly -150.
_POWF_SUBNORMAL_BITS = -(23 << 23)
# glibc's overflow threshold of y log2(x).
_POWF_OVERFLOW = float.fromhex("0x1.fffffffd1d571p+6")


def _powf(x: torch.Tensor, y) -> torch.Tensor:
    invc_tab, logc_tab, exp2_tab = _powf_tables(x.device)
    ix0 = x.view(torch.int32)
    ix = torch.where(ix0 < 0x00800000, _POWF_SUBNORMAL_BITS, ix0)
    tmp = ix - 0x3F330000
    i = ((tmp >> 19) & 15).long()
    top = tmp & -0x800000  # 0xff800000
    z = (ix - top).view(torch.float32).double()
    k = (top >> 23).double()
    # Gathers by torch.take: a 0-d index tensor in [] would be read on the host.
    invc = torch.take(invc_tab, i)
    logc = torch.take(logc_tab, i)
    a = _POWF_A
    r = z * invc - 1.0
    y0 = logc + k
    r2 = r * r
    yv = a[0] * r + a[1]
    p = a[2] * r + a[3]
    r4 = r2 * r2
    q = a[4] * r + y0
    q = p * r2 + q
    logx = yv * r4 + q
    ylogx = (y.double() if isinstance(y, torch.Tensor) else float(y)) * logx
    kd = ylogx + _EXP2F_SHIFT
    ki = kd.view(torch.int64)
    kd = kd - _EXP2F_SHIFT
    r = ylogx - kd
    t = torch.take(exp2_tab, ki & 31) + (ki << 47)
    c = _EXP2F_C
    zc = c[0] * r + c[1]
    r2 = r * r
    yv = c[2] * r + 1.0
    yv = zc * r2 + yv
    out = (yv * t.view(torch.float64)).float()
    out = torch.where(ylogx > _POWF_OVERFLOW, float("inf"), out)
    out = torch.where((ylogx <= -150.0) | (out < float(2.0**-126)), 0.0, out)
    if isinstance(y, torch.Tensor):
        zero_pow = torch.where(y > 0, 0.0, torch.where(y == 0, 1.0, float("inf")))
    else:
        zero_pow = 0.0 if y > 0 else 1.0 if y == 0 else float("inf")
    return torch.where(ix0 == 0, zero_pow, out)



def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt rounded once, as sqrtf (XLA's and the kernels') rounds
    it: torch's vectorised CPU sqrt is off by an ulp in ~0.7% of arguments;
    a float64 sqrt rounded to float32 is exact."""
    return torch.sqrt(x.double()).to(x.dtype)



def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b for (..., 4) quaternions."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )



def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors (..., 3) by quaternions (..., 4): local → world."""
    qw = q[..., :1]
    qv = q[..., 1:]
    # v' = v + 2 qw (qv × v) + 2 qv × (qv × v)
    uv = cross(qv, v)
    return v + 2.0 * (qw * uv + cross(qv, uv))
