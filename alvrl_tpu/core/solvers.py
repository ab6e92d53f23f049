"""Numerical solvers: Brent root finding + Gauss-Lobatto quadrature.

Counterpart of src/libcore/brent.cpp (BrentSolver, used by the
reference's heterogeneous medium to invert density integrals) and
src/libcore/quad.cpp (GaussLobattoIntegrator). `brent` is written as a
fixed-iteration `lax.while_loop` so it jits and vmaps — the device
form of an iterative scalar solver; `gauss_lobatto` is the adaptive
host-side integrator (device code paths use fixed-step composite
rules, which XLA pipelines better than recursion).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def brent(f, a, b, tol: float = 1e-6, max_iter: int = 100):
    """Find a root of f in [a, b] (f(a) f(b) <= 0) by Brent's method
    (inverse quadratic interpolation + secant + bisection fallbacks,
    brent.cpp). Scalar-lane; vmap for batches. Returns (x, converged)."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    fa = f(a)
    fb = f(b)
    # ensure |f(b)| <= |f(a)| (b is the best guess)
    swap = jnp.abs(fa) < jnp.abs(fb)
    a, b = jnp.where(swap, b, a), jnp.where(swap, a, b)
    fa, fb = jnp.where(swap, fb, fa), jnp.where(swap, fa, fb)

    def cond(st):
        _, b_, _, _, fb_, _, _, it, done = st
        return (~done) & (it < max_iter)

    def body(st):
        a_, b_, c_, fa_, fb_, fc_, mflag, it, done = st
        # inverse quadratic interpolation / secant
        use_iqi = (fa_ != fc_) & (fb_ != fc_)
        s_iqi = (
            a_ * fb_ * fc_ / jnp.where(use_iqi, (fa_ - fb_) * (fa_ - fc_), 1.0)
            + b_ * fa_ * fc_ / jnp.where(use_iqi, (fb_ - fa_) * (fb_ - fc_), 1.0)
            + c_ * fa_ * fb_ / jnp.where(use_iqi, (fc_ - fa_) * (fc_ - fb_), 1.0)
        )
        s_sec = b_ - fb_ * (b_ - a_) / jnp.where(
            fb_ != fa_, fb_ - fa_, 1.0)
        s = jnp.where(use_iqi, s_iqi, s_sec)
        lo = (3.0 * a_ + b_) / 4.0
        cond_bisect = (
            ((s < jnp.minimum(lo, b_)) | (s > jnp.maximum(lo, b_)))
            | (mflag & (jnp.abs(s - b_) >= jnp.abs(b_ - c_) / 2.0))
            | (~mflag & (jnp.abs(s - b_) >= jnp.abs(c_ - a_) / 2.0))
        )
        s = jnp.where(cond_bisect, 0.5 * (a_ + b_), s)
        new_mflag = cond_bisect
        fs = f(s)
        c_n, fc_n = b_, fb_
        take_left = fa_ * fs < 0.0
        a_n = jnp.where(take_left, a_, s)
        fa_n = jnp.where(take_left, fa_, fs)
        b_n = jnp.where(take_left, s, b_)
        fb_n = jnp.where(take_left, fs, fb_)
        swap2 = jnp.abs(fa_n) < jnp.abs(fb_n)
        a_n, b_n = jnp.where(swap2, b_n, a_n), jnp.where(swap2, a_n, b_n)
        fa_n, fb_n = (jnp.where(swap2, fb_n, fa_n),
                      jnp.where(swap2, fa_n, fb_n))
        done_n = (jnp.abs(fb_n) < 1e-12) | (jnp.abs(b_n - a_n) < tol)
        return (a_n, b_n, c_n, fa_n, fb_n, fc_n, new_mflag, it + 1,
                done_n)

    st0 = (a, b, a, fa, fb, fa, jnp.bool_(True), jnp.int32(0),
           (fa * fb > 0.0) | (jnp.abs(fb) < 1e-12))
    st = jax.lax.while_loop(cond, body, st0)
    b_fin = st[1]
    converged = st[8] | (jnp.abs(st[4]) < tol)
    return b_fin, converged


# Gauss-Lobatto abscissae/weights on [-1, 1] (order 7 / order 13 pair,
# quad.cpp:GaussLobattoIntegrator)
_GL_X = np.array([0.0, 0.2765863577, 0.5384693101, 0.7541667265,
                  0.8998995404, 0.9840853600, 1.0])


def gauss_lobatto(f, a: float, b: float, tol: float = 1e-8,
                  max_depth: int = 20) -> float:
    """Adaptive Gauss-Lobatto quadrature of a scalar callable on
    [a, b] (host-side recursion, quad.cpp semantics)."""
    alpha = np.sqrt(2.0 / 3.0)
    beta = 1.0 / np.sqrt(5.0)

    def rec(lo, hi, flo, fhi, whole, depth):
        m_ = 0.5 * (lo + hi)
        h = 0.5 * (hi - lo)
        mll, ml, mr, mrr = (m_ - alpha * h, m_ - beta * h,
                            m_ + beta * h, m_ + alpha * h)
        fmll, fml, fm, fmr, fmrr = f(mll), f(ml), f(m_), f(mr), f(mrr)
        i2 = (h / 6.0) * (flo + fhi + 5.0 * (fml + fmr))
        i1 = (h / 1470.0) * (
            77.0 * (flo + fhi) + 432.0 * (fmll + fmrr)
            + 625.0 * (fml + fmr) + 672.0 * fm
        )
        if depth <= 0 or abs(i1 - i2) < tol * max(abs(i1), 1e-30):
            return i1
        return (
            rec(lo, mll, flo, fmll, i1, depth - 1)
            + rec(mll, ml, fmll, fml, i1, depth - 1)
            + rec(ml, m_, fml, fm, i1, depth - 1)
            + rec(m_, mr, fm, fmr, i1, depth - 1)
            + rec(mr, mrr, fmr, fmrr, i1, depth - 1)
            + rec(mrr, hi, fmrr, fhi, i1, depth - 1)
        )

    return float(rec(float(a), float(b), f(float(a)), f(float(b)),
                     0.0, max_depth))
