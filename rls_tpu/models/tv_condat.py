"""Exact 1-D total-variation denoising (Condat's direct algorithm).

Reference: ``tv_denoise_1d_condat!`` (/root/reference/src/proximalMaps/ProxTVCondat.jl:145-249)
and the per-line dispatch for directional TV
(/root/reference/src/proximalMaps/ProxTV.jl:64-79). The reference implements
Condat 2013 ("A direct algorithm for 1D total variation denoising") with
pointer-chasing while-loops; here the same state machine is expressed as a
single flat `lax.while_loop` whose segment writes are masked vector stores,
then `vmap`-ped across all lines of an image. Work per event is O(N) so the
worst case is O(N²), but lines are processed in parallel; the
multi-dimensional TV prox uses FGP instead (see prox.py), exactly like the
reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["tv_denoise_1d_condat", "prox_tv_1d_axis", "prox_tv_condat_nd"]


def tv_denoise_1d_condat(c, lam):
    """Exact TV prox of a 1-D real signal: argmin_u ½‖u−c‖² + λ TV(u)."""
    c = jnp.asarray(c)
    N = c.shape[0]
    if N == 1:
        return c
    idx = jnp.arange(N)
    lam = jnp.asarray(lam, c.dtype)
    one = jnp.asarray(1, c.dtype)

    def write(buf, lo, hi, v):
        return jnp.where((idx >= lo) & (idx <= hi), v, buf)

    def body(s):
        c_, k, k0, km, kp, vmin, vmax, umin, umax, done = s

        def boundary(s):
            c_, k, k0, km, kp, vmin, vmax, umin, umax, done = s

            def case_neg(_):
                c2 = write(c_, k0, km, vmin)
                kn = km + 1
                vminn = c2[kn]
                uminn = lam
                umaxn = vminn + uminn - vmax
                return (c2, kn, kn, kn, kp, vminn, vmax, uminn, umaxn, False)

            def case_pos(_):
                c2 = write(c_, k0, kp, vmax)
                kn = kp + 1
                vmaxn = c2[kn]
                umaxn = -lam
                uminn = vmaxn + umaxn - vmin
                return (c2, kn, kn, km, kn, vmin, vmaxn, uminn, umaxn, False)

            def case_done(_):
                denom = (k - k0 + 1).astype(c_.dtype)
                vminn = vmin + umin / denom
                c2 = write(c_, k0, k, vminn)
                return (c2, k, k0, km, kp, vminn, vmax, umin, umax, True)

            return lax.cond(
                umin < 0,
                case_neg,
                lambda _: lax.cond(umax > 0, case_pos, case_done, None),
                None,
            )

        def main(s):
            c_, k, k0, km, kp, vmin, vmax, umin, umax, done = s
            cnext = c_[k + 1]
            umin_n = umin + cnext - vmin
            umax_n = umax + cnext - vmax

            def neg_jump(_):
                c2 = write(c_, k0, km, vmin)
                kn = km + 1
                vminn = c2[kn]
                return (
                    c2, kn, kn, kn, kn,
                    vminn, vminn + 2 * lam, lam, -lam, False,
                )

            def pos_jump(_):
                c2 = write(c_, k0, kp, vmax)
                kn = kp + 1
                vmaxn = c2[kn]
                return (
                    c2, kn, kn, kn, kn,
                    vmaxn - 2 * lam, vmaxn, lam, -lam, False,
                )

            def advance(_):
                kn = k + 1
                do_min = umin_n >= lam
                kmn = jnp.where(do_min, kn, km)
                seg_min = (kmn - k0 + 1).astype(c_.dtype)
                vminn = jnp.where(do_min, vmin + (umin_n - lam) / seg_min, vmin)
                uminn = jnp.where(do_min, lam, umin_n)
                do_max = umax_n <= -lam
                kpn = jnp.where(do_max, kn, kp)
                seg_max = (kpn - k0 + 1).astype(c_.dtype)
                vmaxn = jnp.where(do_max, vmax + (umax_n + lam) / seg_max, vmax)
                umaxn = jnp.where(do_max, -lam, umax_n)
                return (c_, kn, k0, kmn, kpn, vminn, vmaxn, uminn, umaxn, False)

            return lax.cond(
                umin_n < -lam,
                neg_jump,
                lambda _: lax.cond(umax_n > lam, pos_jump, advance, None),
                None,
            )

        return lax.cond(k == N - 1, boundary, main, s)

    z = jnp.asarray(0, jnp.int32)
    init = (
        c, z, z, z, z,
        c[0] - lam, c[0] + lam, lam * one, -lam * one, False,
    )
    out = lax.while_loop(lambda s: jnp.logical_not(s[-1]), body, init)
    return out[0]


def prox_tv_1d_axis(x_img, lam, axis: int):
    """Exact TV prox applied independently along `axis` of an n-D real image
    (reference ProxTV.jl:64-79, the dims::Integer dispatch)."""
    moved = jnp.moveaxis(x_img, axis, -1)
    lines = moved.reshape(-1, moved.shape[-1])
    den = jax.vmap(lambda row: tv_denoise_1d_condat(row, lam))(lines)
    return jnp.moveaxis(den.reshape(moved.shape), -1, axis)


def prox_tv_condat_nd(x_img, lam):
    """Averaged axis-sweep TV (reference ``proxTVCondat!``,
    ProxTVCondat.jl:4-19): mean over axes of per-axis exact 1-D TV."""
    nd = x_img.ndim
    out = jnp.zeros_like(x_img)
    for d in range(nd):
        out = out + prox_tv_1d_axis(x_img, lam, d) / nd
    return out
