"""Quaternion and spatial (Plücker) algebra on batched tensors.

Port of ``flygym_tpu/engine/maths.py``; conventions are the same:

- Quaternions are (w, x, y, z), normalised, rotating local into world.
- Spatial motion vectors are 6D ``(angular, linear)`` in world axes about a
  reference point; spatial forces are ``(torque, force)`` about it.

Every function broadcasts over leading dimensions. Vector norms are written
as ``sqrt(sum(x * x))``, which is what ``jnp.linalg.norm`` computes, so that
the port rounds where the reference does. Sines, cosines and powers of
float32 are glibc's ``sinf``/``cosf``/``powf`` algorithms (:func:`sinf`,
:func:`cosf`, :func:`powf`), as the JAX package's CPU backend rounds them,
jitted or not.
"""

import struct

import numpy as np
import torch

__all__ = [
    "cosf",
    "cross",
    "cross_fma",
    "fma32",
    "matmul_fma",
    "sinf",
    "sqrt_rn",
    "norm",
    "quat_mul",
    "quat_mul_fma",
    "quat_conj",
    "quat_rotate",
    "quat_rotate_fma",
    "quat_rotate_inv",
    "quat_from_axis_angle",
    "quat_integrate",
    "quat_to_mat",
    "mat_to_quat",
    "normalize_quat",
    "powf",
    "skew",
    "motion_cross",
    "force_cross",
    "spatial_inertia",
]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product of (..., 3) vectors, broadcasting like ``jnp.cross``."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------------------
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


class _SinCosF(torch.autograd.Function):
    """glibc's sinf or cosf with JAX's derivative rules (``sin_p``'s and
    ``cos_p``'s JVPs), g·cos(x) and −g·sin(x), rounded as :func:`cosf` and
    :func:`sinf`: the polynomial's own derivative is another function,
    which autograd would otherwise differentiate."""

    @staticmethod
    def forward(ctx, y, cos: bool):
        ctx.cos = cos
        ctx.save_for_backward(y)
        return _sincosf(y, cos)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return (-(g * sinf(y)) if ctx.cos else g * cosf(y)), None


def sinf(y: torch.Tensor) -> torch.Tensor:
    """sin of a float32 tensor, rounded as glibc's sinf rounds it; its
    gradient is JAX's, g·cosf(x)."""
    return _SinCosF.apply(y, False)


def cosf(y: torch.Tensor) -> torch.Tensor:
    """cos of a float32 tensor, rounded as glibc's cosf rounds it; its
    gradient is JAX's, −g·sinf(x)."""
    return _SinCosF.apply(y, True)


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


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    """``g`` summed over the dimensions along which an operand of ``shape``
    was broadcast to ``g``'s shape."""
    lead = g.dim() - len(shape)
    if lead:
        g = g.sum(dim=tuple(range(lead)))
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and g.shape[i] != 1)
    return g.sum(dim=dims, keepdim=True) if dims else g


class _PowF(torch.autograd.Function):
    """glibc's powf with JAX's derivative rules (``_pow_jvp_lhs`` and
    ``_pow_jvp_rhs`` of ``jax/_src/lax/lax.py``), each power rounded as
    :func:`powf`: for x, g·y·x^(y−1), and 0 where y = 0; for a tensor
    exponent y, g·log(x)·x^y, x = 0 read as 1 inside the log. The forward
    goes through the integer bits of x, which autograd cannot see."""

    @staticmethod
    def forward(ctx, x, y):
        if not isinstance(y, torch.Tensor):
            y = _f32(y)  # a Python exponent is float32 to jnp.power
        out = _powf(x, y)
        ctx.y_float = None if isinstance(y, torch.Tensor) else y
        ctx.save_for_backward(x, out, y if isinstance(y, torch.Tensor) else None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out, y_t = ctx.saved_tensors
        y = ctx.y_float if y_t is None else y_t
        gx = gy = None
        if ctx.needs_input_grad[0]:
            jac = y * powf(x, y - 1.0 if y_t is not None else _f32(y - 1.0))
            if y_t is None:
                gx = torch.zeros_like(g) if y == 0 else g * jac
            else:
                gx = torch.where(y_t == 0, 0.0, g * jac)
            gx = _sum_to(gx, x.shape)
        if y_t is not None and ctx.needs_input_grad[1]:
            gy = _sum_to(g * (torch.log(torch.where(x == 0, 1.0, x)) * out), y_t.shape)
        return gx, gy


def powf(x: torch.Tensor, y) -> torch.Tensor:
    """x ** y of a float32 tensor x >= 0 and a finite exponent ``y`` (a
    float or a float32 tensor), rounded as glibc's powf rounds it under
    XLA's CPU backend, which reads subnormal floats as zero: glibc
    normalises a subnormal x as the bits of x * 2^23 less 23 exponents,
    which then reads as 2^-150, so x^y is 2^(-150 y); a result below 2^-126
    is 0, 0^y is 0, 1 or inf as y > 0, = 0 or < 0, and a result past the
    float range is inf. Negative or non-finite arguments are not handled.
    Its gradients are JAX's rules (:class:`_PowF`)."""
    return _PowF.apply(x, y)


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


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of float32 tensors rounded once, as a fused multiply-add
    rounds it (XLA's CPU backend contracts a multiply feeding an add into
    one): the product is exact in float64 and the sum is rounded to float64,
    then to float32. That double rounding differs from one rounding only
    where the float64 sum lands exactly halfway between two float32 values
    without being so, about once in 2^29 sums."""
    return (a.double() * b.double() + c.double()).float()


# The quaternion algebra as the JAX package's jitted programs round it on
# the CPU: XLA contracts a product feeding a sum into one fused multiply-add
# (which product of a sum it fuses depends on the program; these are the
# pairs of the jitted plane sampler, engine/terrain.py, and of the jitted
# neutral-pose kinematics, engine/model.py:make_initial_state).


def cross_fma(a, b):
    """a × b as XLA's CPU backend fuses ``jnp.cross`` under ``jit``:
    fma(a1, b2, -(a2 b1)), ..."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([fma32(a1, b2, -(a2 * b1)), fma32(a2, b0, -(a0 * b2)),
                        fma32(a0, b1, -(a1 * b0))], dim=-1)


def quat_rotate_fma(q, v):
    """``quat_rotate`` fused: v + 2 (qw uv + qv × uv), uv = qv × v."""
    qw, qv = q[..., :1], q[..., 1:]
    uv = cross_fma(qv, v)
    t = fma32(qw, uv, cross_fma(qv, uv))
    return fma32(torch.full_like(t, 2.0), t, v)


def quat_mul_fma(a, b):
    """``quat_mul`` fused: each component a chain of fused multiply-adds
    from its first two products on."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        fma32(-az, bz, fma32(-ay, by, fma32(aw, bw, -(ax * bx)))),
        fma32(-az, by, fma32(ay, bz, fma32(aw, bx, ax * bw))),
        fma32(az, bx, fma32(ay, bw, fma32(aw, by, -(ax * bz)))),
        fma32(az, bw, fma32(-ay, bx, fma32(aw, bz, ax * by))),
    ], dim=-1)


def matmul_fma(a: torch.Tensor, b: torch.Tensor, lanes: int = 1) -> torch.Tensor:
    """``a @ b`` of float32 tensors with each sum rounded in the order of
    XLA's CPU dot (a runtime call, not a fusion), read off its results:

    - ``lanes=1``: one fused multiply-add chain over k in order (the batched
      3 x 3 and 6 x 6 products of the mass matrix);
    - ``lanes=2`` or ``4``: the first k rounded down to a multiple of
      ``lanes`` go round-robin into that many chains, which are then added
      in adjacent pairs ((0 + 1) + (2 + 3)); the rest of k is one more chain,
      added last (the (nv, 6) @ (6, nv) product takes 2, the subtree mask's
      (nbody, nbody) @ (nbody, 36) product 4).
    """
    k = a.shape[-1]
    full = k // lanes * lanes

    def chain(ks):
        acc = None
        for i in ks:
            x, y = a[..., :, i : i + 1], b[..., i : i + 1, :]
            acc = x * y if acc is None else fma32(x, y, acc)
        return acc

    parts = [chain(range(lane, full, lanes)) for lane in range(lanes if full else 0)]
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    rest = chain(range(full, k))
    if not parts:
        return rest
    return parts[0] if rest is None else parts[0] + rest


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt rounded once, as sqrtf (XLA's and the kernels') rounds
    it: torch's vectorised CPU sqrt is off by an ulp in ~0.7% of arguments;
    a float64 sqrt rounded to float32 is exact."""
    return torch.sqrt(x.double()).to(x.dtype)


def norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


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


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (= inverse for unit quaternions)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors (..., 3) by quaternions (..., 4): local → world."""
    qw = q[..., :1]
    qv = q[..., 1:]
    # v' = v + 2 qw (qv × v) + 2 qv × (qv × v)
    uv = cross(qv, v)
    return v + 2.0 * (qw * uv + cross(qv, uv))


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate by the inverse quaternion: world → local."""
    return quat_rotate(quat_conj(q), v)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit quaternion for a rotation of ``angle`` (...,) about ``axis`` (..., 3)."""
    half = 0.5 * angle[..., None]
    xyz = sinf(half) * axis
    w = cosf(half).expand(xyz.shape[:-1] + (1,))
    return torch.cat([w, xyz], dim=-1)


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """Integrate orientation by a world-frame angular velocity over dt.

    Exact exponential map: q' = exp(ω dt / 2) ⊗ q.
    """
    rot = omega_world * dt
    angle = norm(rot)
    # Safe normalise: the axis is irrelevant when the angle is ~0.
    axis = rot / torch.clamp(angle[..., None], min=1e-12)
    dq = quat_from_axis_angle(axis, angle)
    return normalize_quat(quat_mul(dq, q))


def normalize_quat(q: torch.Tensor) -> torch.Tensor:
    return q / norm(q, keepdim=True)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) → rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) → unit quaternion (..., 4), w-first.

    Branch-free Shepperd's method: all four candidates, the strongest chosen
    with ``where``.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw_t = 0.5 * safe_sqrt(1.0 + tr)
    q_t = torch.stack(
        [qw_t, (m21 - m12) / (4 * qw_t), (m02 - m20) / (4 * qw_t),
         (m10 - m01) / (4 * qw_t)], dim=-1)
    qx_x = 0.5 * safe_sqrt(1.0 + m00 - m11 - m22)
    q_x = torch.stack(
        [(m21 - m12) / (4 * qx_x), qx_x, (m01 + m10) / (4 * qx_x),
         (m02 + m20) / (4 * qx_x)], dim=-1)
    qy_y = 0.5 * safe_sqrt(1.0 - m00 + m11 - m22)
    q_y = torch.stack(
        [(m02 - m20) / (4 * qy_y), (m01 + m10) / (4 * qy_y), qy_y,
         (m12 + m21) / (4 * qy_y)], dim=-1)
    qz_z = 0.5 * safe_sqrt(1.0 - m00 - m11 + m22)
    q_z = torch.stack(
        [(m10 - m01) / (4 * qz_z), (m02 + m20) / (4 * qz_z),
         (m12 + m21) / (4 * qz_z), qz_z], dim=-1)

    use_t = tr > 0.0
    use_x = (~use_t) & (m00 >= m11) & (m00 >= m22)
    use_y = (~use_t) & (~use_x) & (m11 >= m22)
    q = torch.where(
        use_t[..., None], q_t,
        torch.where(use_x[..., None], q_x, torch.where(use_y[..., None], q_y, q_z)),
    )
    return normalize_quat(q)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrices of (..., 3) vectors: (..., 3, 3)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def motion_cross(m: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product m ×̂ other for (..., 6) motion vectors."""
    w, v = m[..., :3], m[..., 3:]
    ow, ov = other[..., :3], other[..., 3:]
    return torch.cat([cross(w, ow), cross(w, ov) + cross(v, ow)], dim=-1)


def force_cross(m: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product m ×̂* f (motion (..., 6) acting on force)."""
    w, v = m[..., :3], m[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, n) + cross(v, fl), cross(w, fl)], dim=-1)


def spatial_inertia(
    mass: torch.Tensor, inertia_world: torch.Tensor, com_offset: torch.Tensor
) -> torch.Tensor:
    """Spatial inertia (..., 6, 6) about a reference point.

    Args:
        mass: (...,) body mass.
        inertia_world: (..., 3, 3) rotational inertia about the com, world axes.
        com_offset: (..., 3) com relative to the reference point, world axes.

    Featherstone: I = [[Ī + m c× c×ᵀ, m c×], [m c×ᵀ, m·1]].
    """
    c = skew(com_offset)
    ct = c.transpose(-1, -2)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=com_offset.dtype, device=com_offset.device).expand(c.shape)
    top_left = inertia_world + m * (c @ ct)
    top_right = m * c
    bottom_left = m * ct
    bottom_right = m * eye
    top = torch.cat([top_left, top_right], dim=-1)
    bottom = torch.cat([bottom_left, bottom_right], dim=-1)
    return torch.cat([top, bottom], dim=-2)
