"""Plain float64 numpy references for the solvers and operators.

Each function restates one solver's recurrence (the reference
RegularizedLeastSquares.jl semantics as `rls_tpu` implements them) in
straight numpy, independent of `rls_tpu`: no JAX, no compensated
products, no batching. The tests and `chip_smoke.py` compare the composed
JAX path against these at float64.

Operators are small classes with ``mv``/``rmv``; proxes are callables
``prox(x, t)`` applying the map with threshold ``t``; projections are
callables ``proj(x)``.
"""

from __future__ import annotations

import numpy as np

F64 = np.float64


def _vdot(a, b):
    return np.vdot(a, b)  # conjugates a, like jnp.vdot


# --------------------------------------------------------------------------
# operators
# --------------------------------------------------------------------------


class Dense:
    def __init__(self, A):
        self.A = np.asarray(A)
        self.A = self.A.astype(np.complex128 if np.iscomplexobj(self.A) else F64)

    def mv(self, x):
        return self.A @ x

    def rmv(self, y):
        return self.A.conj().T @ y


def banded(n, taps):
    """(n, n) matrix of SAME zero-padded 1-D convolution with odd `taps`."""
    taps = np.asarray(taps, F64)
    k = taps.shape[0]
    m = np.zeros((n, n), F64)
    for i, t in enumerate(taps):
        off = i - k // 2
        m += np.diag(np.full(n - abs(off), t), k=off)
    return m


class SepConv:
    """SAME zero-padded 2-D convolution with kernel outer(taps_h, taps_w)."""

    def __init__(self, taps_h, taps_w, shape):
        self.shape = tuple(shape)
        self.ah = banded(shape[0], taps_h)
        self.aw = banded(shape[1], taps_w)

    def mv(self, x):
        return (self.ah @ x.reshape(self.shape) @ self.aw.T).reshape(-1)

    def rmv(self, y):
        return (self.ah.T @ y.reshape(self.shape) @ self.aw).reshape(-1)


def separable_taps(kernel):
    """Rank-1 factors of a separable 2-D kernel (dominant tap positive)."""
    u, s, vt = np.linalg.svd(np.asarray(kernel, F64))
    th, tw = u[:, 0] * np.sqrt(s[0]), vt[0] * np.sqrt(s[0])
    if th[len(th) // 2] < 0:
        th, tw = -th, -tw
    return th, tw


class SubsampledDFT:
    """Masked unitary 2-D DFT of a real image; output stacked [re; im]."""

    def __init__(self, mask, shape):
        self.shape = tuple(shape)
        self.mask = np.asarray(mask, F64).reshape(shape)

    def mv(self, x):
        k = np.fft.fft2(x.reshape(self.shape), norm="ortho") * self.mask
        return np.concatenate([k.real.ravel(), k.imag.ravel()])

    def rmv(self, y):
        n = y.size // 2
        k = (y[:n] + 1j * y[n:]).reshape(self.shape) * self.mask
        return np.fft.ifft2(k, norm="ortho").real.ravel()


class Sense:
    """Multi-coil SENSE ``stack_c(M ∘ F ∘ C_c)`` on split [re; im] vectors;
    k-space stacked as (C, 2, H, W)."""

    def __init__(self, maps, mask, shape):
        self.shape = tuple(shape)
        self.maps = np.asarray(maps, np.complex128)
        self.mask = np.asarray(mask, F64).reshape(shape)

    def mv(self, x):
        n = x.size // 2
        img = (x[:n] + 1j * x[n:]).reshape(self.shape)
        k = np.fft.fft2(self.maps * img, norm="ortho") * self.mask
        return np.stack([k.real, k.imag], axis=1).ravel()

    def rmv(self, y):
        c = self.maps.shape[0]
        k = y.reshape(c, 2, *self.shape)
        k = (k[:, 0] + 1j * k[:, 1]) * self.mask
        img = np.sum(self.maps.conj() * np.fft.ifft2(k, norm="ortho"), axis=0)
        return np.concatenate([img.real.ravel(), img.imag.ravel()])


class Gradient:
    """Forward differences along `dims`, blocks concatenated."""

    def __init__(self, shape, dims=None):
        self.shape = tuple(shape)
        self.dims = tuple(range(len(shape))) if dims is None else tuple(dims)

    def mv(self, x):
        im = x.reshape(self.shape)
        return np.concatenate([np.diff(im, axis=d).ravel() for d in self.dims])

    def rmv(self, y):
        out = np.zeros(self.shape, y.dtype)
        off = 0
        for d in self.dims:
            dshape = tuple(s - 1 if i == d else s for i, s in enumerate(self.shape))
            size = int(np.prod(dshape))
            diff = y[off:off + size].reshape(dshape)
            lo = [slice(None)] * len(self.shape)
            hi = [slice(None)] * len(self.shape)
            lo[d], hi[d] = slice(0, -1), slice(1, None)
            out[tuple(lo)] -= diff
            out[tuple(hi)] += diff
            off += size
        return out.ravel()


# (row slice of the minuend, row slice of the subtrahend) per direction of
# the reference's 8-direction PDHG gradient; columns likewise
def _grad8_slices(m, n):
    s = slice
    return [
        ((s(0, m - 1), s(0, n)), (s(1, m), s(0, n))),
        ((s(0, m), s(0, n - 1)), (s(0, m), s(1, n))),
        ((s(0, m - 1), s(0, n - 1)), (s(1, m), s(1, n))),
        ((s(0, m - 1), s(1, n)), (s(1, m), s(0, n - 1))),
        ((s(0, m - 2), s(0, n - 1)), (s(2, m), s(1, n))),
        ((s(0, m - 2), s(1, n)), (s(2, m), s(0, n - 1))),
        ((s(0, m - 1), s(0, n - 2)), (s(1, m), s(2, n))),
        ((s(0, m - 1), s(2, n)), (s(1, m), s(0, n - 2))),
    ]


class Grad8:
    """8-direction differences (axial, diagonal, knight) as 8 planes."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def mv(self, x):
        u = x.reshape(self.shape)
        planes = []
        for a, b in _grad8_slices(*self.shape):
            p = np.zeros(self.shape, u.dtype)
            p[a] = u[a] - u[b]
            planes.append(p.ravel())
        return np.concatenate(planes)

    def rmv(self, y):
        p = y.reshape(8, *self.shape)
        out = np.zeros(self.shape, y.dtype)
        for k, (a, b) in enumerate(_grad8_slices(*self.shape)):
            out[a] += p[k][a]
            out[b] -= p[k][a]
        return out.ravel()


class Identity:
    def mv(self, x):
        return x

    def rmv(self, y):
        return y


# --------------------------------------------------------------------------
# proximal maps and projections
# --------------------------------------------------------------------------


def soft_threshold(x, t):
    eps = np.finfo(F64).eps
    mag = np.abs(x)
    return np.maximum(mag - t, 0) * (x + eps) / (mag + eps)


def l21_prox(slices):
    def prox(x, t):
        x2 = x.reshape(slices, -1)
        gn = np.sqrt(np.sum(np.abs(x2) ** 2, axis=0))
        scale = np.maximum((gn - t) / np.where(gn == 0, 1.0, gn), 0)
        return (x2 * scale).ravel()

    return prox


def l2_prox(x, t):
    return x / (1.0 + 2.0 * t)


def tv_prox(shape, dims=None, iterations=10):
    """FGP on the TV dual with the per-element (anisotropic) projection."""
    G = Gradient(shape, dims)

    def prox(x, t):
        t_safe = t if t > 0 else 1.0
        pq = np.zeros_like(G.mv(x))
        rs = pq.copy()
        th = 1.0
        for _ in range(iterations):
            pq_old = pq
            xtmp = x - t * G.rmv(rs)
            pq = rs + G.mv(xtmp) / (8.0 * t_safe)
            pq = pq / np.maximum(1.0, np.abs(pq))
            th_new = (1.0 + np.sqrt(1.0 + 4.0 * th * th)) / 2.0
            rs = pq + (th - 1.0) / th_new * (pq - pq_old)
            th = th_new
        return x - t * G.rmv(pq)

    return prox


def positive(x):
    return np.maximum(np.real(x), 0).astype(x.dtype)


def svt_blocks(img, block, t):
    """Blockwise singular-value soft threshold of an (H, W, K) stack over
    non-overlapping blocks (dims divisible by the block)."""
    h, w, k = img.shape
    bh, bw = block
    out = np.empty_like(img)
    for i in range(0, h, bh):
        for j in range(0, w, bw):
            m = img[i:i + bh, j:j + bw].reshape(bh * bw, k)
            u, s, vh = np.linalg.svd(m, full_matrices=False)
            out[i:i + bh, j:j + bw] = ((u * np.maximum(s - t, 0)) @ vh).reshape(bh, bw, k)
    return out


# --------------------------------------------------------------------------
# solvers
# --------------------------------------------------------------------------


def _normal(op):
    return lambda v: op.rmv(op.mv(v))


def fista(op, b, prox, lam, rho, iterations, restart="none", proj=(),
          rel_tol=0.0, track_residual=True):
    AHA = _normal(op)
    x0hat = op.rmv(b)
    x = np.zeros_like(x0hat)
    x_old = np.zeros_like(x0hat)
    th = th_old = 1.0
    norm_x0 = np.linalg.norm(x0hat)
    for _ in range(iterations):
        x_mom = x + (th_old - 1.0) / th * (x - x_old)
        res = AHA(x_mom) - x0hat
        xn = prox(x_mom - rho * res, rho * lam)
        for p in proj:
            xn = p(xn)
        if restart == "gradient" and np.real(_vdot(res, xn - x)) > 0:
            th = 1.0
        elif restart == "gradient_mapping" and np.real(_vdot(x_mom - xn, xn - x)) > 0:
            th = 1.0
        th_old, th = th, (1.0 + np.sqrt(1.0 + 4.0 * th * th)) / 2.0
        x_old, x = x, xn
        if track_residual and np.linalg.norm(res) / norm_x0 < rel_tol:
            break
    return x


def optista(op, b, prox, lam, rho, iterations):
    AHA = _normal(op)
    x0hat = op.rmv(b)
    x = np.zeros_like(x0hat)
    y, z = x.copy(), x.copy()
    tn = 1.0
    for _ in range(iterations - 1):
        tn = (1.0 + np.sqrt(1.0 + 4.0 * tn**2)) / 2.0
    theta_n = (1.0 + np.sqrt(1.0 + 8.0 * tn**2)) / 2.0
    th = 1.0
    for it in range(iterations):
        gamma = 2.0 * th / theta_n**2 * (theta_n**2 - 2.0 * th**2 + th)
        c = 8.0 if it == iterations - 1 else 4.0
        th_new = (1.0 + np.sqrt(1.0 + c * th**2)) / 2.0
        alpha, beta = (th - 1.0) / th_new, th / th_new
        z_old, y_old = z, y
        res = AHA(x) - x0hat
        y = prox(y - rho * gamma * res, rho * gamma * lam)
        z = x + (y - y_old) / gamma
        x = (1.0 + alpha + beta) * z - alpha * z_old - beta * x
        th = th_new
    return x


def pogm(op, b, prox, lam, rho, iterations, restart="none", sigma_fac=1.0,
         proj=(), rel_tol=0.0):
    AHA = _normal(op)
    x0hat = op.rmv(b)
    x = np.zeros_like(x0hat)
    y, z, w = x.copy(), x.copy(), x.copy()
    th, gamma, sigma = 1.0, 1.0, 1.0
    norm_x0 = np.linalg.norm(x0hat)
    for it in range(iterations):
        x_old = x
        res = AHA(x) - x0hat
        xg = x - rho * res
        c = 8.0 if (restart != "none" and it == iterations - 1) else 4.0
        th_old, th = th, (1.0 + np.sqrt(1.0 + c * th**2)) / 2.0
        alpha, beta = (th_old - 1.0) / th, sigma * th_old / th
        gamma_old = gamma
        if restart == "gradient":
            gamma = rho * (1.0 + alpha + beta)
        else:
            gamma = rho * (2.0 * th_old + th - 1.0) / th
        y_old, y = y, xg
        k = rho * alpha / gamma_old
        x = (1.0 + alpha + beta) * y - alpha * y_old - (beta + k) * x_old + k * z
        z = x
        x = prox(x, gamma * lam)
        for p in proj:
            x = p(x)
        if restart == "gradient":
            w = w + y + rho / gamma * (x - z)
            crit = np.real((_vdot(w, x) - _vdot(w, z)) / gamma - _vdot(w, res))
            if crit < 0:
                sigma, th = 1.0, 1.0
            else:
                sigma = sigma * sigma_fac
            w = rho / gamma * (z - x) - y
        if np.linalg.norm(res) / norm_x0 < rel_tol:
            break
    return x


def pcg(mv, b, x, maxiter, reltol):
    r = b - mv(x)
    p = r.copy()
    rz = _vdot(r, r)
    target = reltol * np.linalg.norm(b)
    for _ in range(maxiter):
        if np.linalg.norm(r) <= target:
            break
        q = mv(p)
        alpha = rz / _vdot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        rz_new = _vdot(r, r)
        p = r + rz_new / rz * p
        rz = rz_new
    return x


def _admm_inner(op, trafos, proxes, lams, rhos, beta_y, x, z, u, cg_iters,
                tol_inner, proj, prox_scale):
    AHA = _normal(op)

    def mv(v):
        out = AHA(v)
        for T, r in zip(trafos, rhos):
            out = out + r * T.rmv(T.mv(v))
        return out

    beta = beta_y
    for T, r, zi, ui in zip(trafos, rhos, z, u):
        beta = beta + r * T.rmv(zi - ui)
    x = pcg(mv, beta, x, cg_iters, tol_inner)
    for p in proj:
        x = p(x)
    for i, (T, prox, lam, r) in enumerate(zip(trafos, proxes, lams, rhos)):
        phix = T.mv(x)
        zi = prox(phix + u[i], lam / (prox_scale * r))
        u[i] = u[i] + phix - zi
        z[i] = zi
    return x


def admm(op, b, proxes, lams, rhos, iterations, cg_iters, trafos=None,
         proj=(), tol_inner=1e-5):
    trafos = trafos or [Identity() for _ in proxes]
    beta_y = op.rmv(b)
    x = np.zeros_like(beta_y)
    z = [T.mv(x) for T in trafos]
    u = [np.zeros_like(zi) for zi in z]
    for _ in range(iterations):
        x = _admm_inner(op, trafos, proxes, lams, rhos, beta_y, x, z, u,
                        cg_iters, tol_inner, proj, prox_scale=2.0)
    return x


def split_bregman(op, b, proxes, lams, rhos, iterations, iterations_inner,
                  cg_iters, trafos=None, proj=(), tol_inner=1e-5):
    trafos = trafos or [Identity() for _ in proxes]
    y = beta_y = op.rmv(b)
    x = np.zeros_like(beta_y)
    z = [T.mv(x) for T in trafos]
    u = [np.zeros_like(zi) for zi in z]
    for _ in range(iterations):
        for _ in range(iterations_inner):
            x = _admm_inner(op, trafos, proxes, lams, rhos, beta_y, x, z, u,
                            cg_iters, tol_inner, proj, prox_scale=1.0)
        beta_y = beta_y + y - op.rmv(op.mv(x))
        z = [T.mv(x) for T in trafos]
        u = [np.zeros_like(zi) for zi in z]
    return x


def cgnr(op, b, lam, iterations, n, constr=(), rel_tol=0.0):
    AHA = _normal(op)
    r = op.rmv(b)
    x = np.zeros_like(r)
    p = r.copy()
    z0 = np.linalg.norm(r)
    for _ in range(min(iterations, n)):
        v = AHA(p)
        zeta = np.linalg.norm(r) ** 2
        denom = _vdot(p, v) + lam * np.linalg.norm(p) ** 2
        alpha = zeta / (denom if denom != 0 else 1.0) if zeta > 0 else 0.0
        x = x + alpha * p
        r = r - alpha * v - lam * alpha * p
        p = r + np.linalg.norm(r) ** 2 / (zeta if zeta > 0 else 1.0) * p
        if np.linalg.norm(r) / z0 <= rel_tol:
            break
    for c in constr:
        x = c(x)
    return x


_W8 = (5.0**0.5 - 2.0, 5.0**0.5 - 3.0 * 2.0**0.5 / 2.0, (1.0 + 2.0**0.5 - 5.0**0.5) / 2.0)


def tv_conj_8dir(shape):
    weights = (_W8[0], _W8[0], _W8[1], _W8[1], _W8[2], _W8[2], _W8[2], _W8[2])

    def prox(p, a):
        planes = list(p.reshape(8, -1))
        for k in range(8):
            gnorm = np.sqrt(sum(q * q for q in planes))
            planes[k] = weights[k] * np.sign(planes[k]) * np.minimum(gnorm, a)
        return np.concatenate(planes)

    return prox


def ball_clamp(p, a):
    mag = np.abs(p)
    return np.where(mag > a, p / np.maximum(mag, 1e-300) * a, p)


def pdhg(op, b, trafo, conj_prox, lam, sigma, tau, iterations, proj=(), eps=1e-10):
    x = np.zeros(op.rmv(b).shape, np.result_type(b, F64))
    y1 = np.zeros_like(b)
    y2 = np.zeros_like(trafo.mv(x))
    for _ in range(iterations):
        y1 = (y1 + sigma * (op.mv(x) - b)) / (1.0 + sigma)
        y2 = conj_prox(y2 + sigma * trafo.mv(x), lam)
        x = x - tau * (op.rmv(y1) + trafo.rmv(y2))
        for p in proj:
            x = p(x)
        gap = abs(0.5 * np.linalg.norm(op.mv(x) - b) ** 2 + lam * np.sum(np.abs(x))
                  + 0.5 * np.linalg.norm(y1) ** 2 + np.real(_vdot(y1, b)))
        if gap < eps:
            break
    return x


def kaczmarz(A, b, lam, sweeps, proxes=(), lam_vec=None):
    """Regularized Kaczmarz: `sweeps` is a list of row-index sequences (one
    per sweep); `proxes` are applied after every sweep. A vector ``lam_vec``
    runs the standard-form transform with unit λ."""
    A = np.asarray(A)
    A = A.astype(np.complex128 if np.iscomplexobj(A) else F64)
    scale = None
    if lam_vec is not None:
        scale = 1.0 / np.sqrt(np.asarray(lam_vec, F64))
        A = A * scale[None, :]
        lam = 1.0
    dt = np.result_type(A, b)
    b = np.asarray(b, dt)
    rn2 = np.sum(np.abs(A) ** 2, axis=1)
    denom = np.where(rn2 > 0, 1.0 / (rn2 + lam), 0.0)
    eps_w = np.sqrt(lam)
    x = np.zeros(A.shape[1], dt)
    vl = np.zeros(A.shape[0], dt)
    for rows in sweeps:
        for j in rows:
            alpha = denom[j] * (b[j] - A[j] @ x - eps_w * vl[j])
            x = x + alpha * A[j].conj()
            vl[j] += alpha * eps_w
        for p in proxes:
            x = p(x)
    return x if scale is None else x * scale


def tikhonov_lstsq(A, b, lam):
    """argmin ‖Ax − b‖² + λ‖x‖² — the fixed point the Kaczmarz family
    (any row order) converges to."""
    A = np.asarray(A, np.result_type(A, F64))
    n = A.shape[1]
    return np.linalg.solve(A.conj().T @ A + lam * np.eye(n), A.conj().T @ b)


def rel_err(got, want):
    """Max over columns of ‖got − want‖ / ‖want‖ (columns = problems)."""
    got = np.asarray(got).reshape(np.shape(want)[0], -1)
    want = np.asarray(want).reshape(np.shape(want)[0], -1)
    return float(max(
        np.linalg.norm(got[:, j] - want[:, j]) / np.linalg.norm(want[:, j])
        for j in range(want.shape[1])
    ))
