"""The jnp 3D stencil ops on the flow step's hot path against independent
float64 numpy oracles, written from the reference's kernel definitions:

- ENO3 conservative advection (Shu 1997 face reconstruction of the flux
  ``u q``, upwinded by the face velocity; zero ghost cells at the walls);
- diffusion (undivided 7-point Laplacian, width-1 wall band untouched),
  alone and followed by the sine-sponge wall penalisation;
- curl with the free-stream add (central differences, width-1 wall band
  zeroed, free stream added everywhere) and the rotational-form update
  ``omega + dt/(2 dx) curl(u x omega)``;
- the Laplacian filter, multiplicative and convolution types.

Shapes include odd and strongly anisotropic grids.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sopht_mpi_tpu.ops import (
    add_fixed_val,
    advection_timestep_eno3_3d,
    cross_product_3d,
    curl_3d,
    diffusion_timestep_vector_3d,
    laplacian_filter_vector_3d,
    penalise_field_boundary_vector_3d,
    update_vorticity_from_velocity_forcing_3d,
)

SHAPES = [(16, 16, 16), (12, 8, 16), (12, 10, 16), (10, 32, 24),
          (8, 32, 256), (8, 8, 8), (7, 9, 11)]


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, *shape)),
            rng.standard_normal((3, *shape)))


def _interior(a):
    """Slices of the interior of the last three axes."""
    return (...,) + (slice(1, -1),) * 3


def _shift(a, axis, off):
    """a[i + off] along grid ``axis`` (0, 1, 2 = z, y, x) on the interior."""
    idx = [slice(1, -1)] * 3
    n = a.shape[a.ndim - 3 + axis]
    idx[axis] = slice(1 + off, n - 1 + off)
    return a[(...,) + tuple(idx)]


def np_diffusion(w, a):
    out = w.copy()
    lap = -6.0 * w[_interior(w)]
    for ax in range(3):
        lap += _shift(w, ax, 1) + _shift(w, ax, -1)
    out[_interior(w)] += a * lap
    return out


def np_curl(w, prefactor):
    """(x, y, z) components over grid axes (z, y, x): component c varies
    along axis 2 - c."""
    d = lambda comp, ax: _shift(w[comp], ax, 1) - _shift(w[comp], ax, -1)
    z, y, x = 0, 1, 2
    out = np.zeros_like(w)
    out[(0,) + _interior(w[0])[1:]] = prefactor * (d(2, y) - d(1, z))
    out[(1,) + _interior(w[0])[1:]] = prefactor * (d(0, z) - d(2, x))
    out[(2,) + _interior(w[0])[1:]] = prefactor * (d(1, x) - d(0, y))
    return out


def np_penalise(f, width):
    """Sine sponge per axis, x then y then z: a band cell at distance d
    (cells) from a wall takes the band's inner-edge cell value times
    sin(pi/2 d / width)."""
    f = f.copy()
    for ax in (2, 1, 0):
        g = np.moveaxis(f, ax, 0).copy()
        n = g.shape[0]
        lo, hi = g[width - 1].copy(), g[n - width].copy()
        for d in range(width):
            ramp = np.sin(0.5 * np.pi * d / width)
            g[d] = lo * ramp
            g[n - 1 - d] = hi * ramp
        f = np.moveaxis(g, 0, ax)
    return f


def np_highpass(f, ax):
    """0.25 (2 f[i] - f[i+1] - f[i-1]) on the interior along ``ax``,
    then every wall cell of every axis cleared."""
    g = np.moveaxis(f, ax, 0)
    h = np.zeros_like(g)
    h[1:-1] = 0.25 * (2.0 * g[1:-1] - g[2:] - g[:-2])
    h = np.moveaxis(h, 0, ax)
    out = np.zeros_like(h)
    out[1:-1, 1:-1, 1:-1] = h[1:-1, 1:-1, 1:-1]
    return out


def np_laplacian_filter(f, order, kind):
    if kind == "multiplicative":
        buf = f
        for _ in range(order):
            for ax in (2, 1, 0):
                buf = np_highpass(buf, ax)
        return f - buf
    for ax in (2, 1, 0):
        buf = f
        for _ in range(order):
            buf = np_highpass(buf, ax)
        f = f - buf
    return f


def _eno3_face(g):
    """Left-biased ENO3 value at face i+1/2 from g[i-2 .. i+2] (rows of
    ``g``): grow the stencil from cell i toward the smaller undivided
    difference, twice, then apply that 3-cell stencil's coefficients."""
    gm2, gm1, g0, gp1, gp2 = g
    left = np.abs(g0 - gm1) < np.abs(gp1 - g0)
    left2 = np.abs(g0 - 2 * gm1 + gm2) < np.abs(gp1 - 2 * g0 + gm1)
    right2 = np.abs(gp1 - 2 * g0 + gm1) < np.abs(gp2 - 2 * gp1 + g0)
    s_m2 = (2 * gm2 - 7 * gm1 + 11 * g0) / 6  # cells {i-2, i-1, i}
    s_m1 = (-gm1 + 5 * g0 + 2 * gp1) / 6  # cells {i-1, i, i+1}
    s_0 = (2 * g0 + 5 * gp1 - gp2) / 6  # cells {i, i+1, i+2}
    return np.where(left, np.where(left2, s_m2, s_m1),
                    np.where(right2, s_m1, s_0))


def np_eno3_advection(q, u, dt_by_dx):
    """q - dt/dx sum_axes (F_{i+1/2} - F_{i-1/2}) with F the ENO3 face
    value of ``u q`` from the upwind side of the face velocity."""
    out = q.copy()
    for ax in range(3):
        vel = np.moveaxis(u[2 - ax], ax, 0)
        qa = np.moveaxis(q, ax, 0)
        n = qa.shape[0]
        g = np.concatenate([np.zeros((3, *qa.shape[1:])), vel * qa,
                            np.zeros((3, *qa.shape[1:]))])
        up = np.concatenate([np.zeros((3, *qa.shape[1:])), vel,
                             np.zeros((3, *qa.shape[1:]))])
        faces = []
        for j in range(2, n + 3):  # face between padded cells j and j+1
            pos = _eno3_face(g[j - 2:j + 3])
            neg = _eno3_face(g[j - 1:j + 4][::-1])
            faces.append(np.where(0.5 * (up[j] + up[j + 1]) >= 0, pos, neg))
        faces = np.stack(faces)
        div = faces[1:] - faces[:-1]
        out -= dt_by_dx * np.moveaxis(div, 0, ax)
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_eno3_advection_matches_f64_oracle(shape):
    q, u = _fields(shape, 1)
    q = q[0]
    got = advection_timestep_eno3_3d(jnp.asarray(q), jnp.asarray(u), 0.05)
    np.testing.assert_allclose(np.asarray(got),
                               np_eno3_advection(q, u, 0.05), atol=1e-12)


@pytest.mark.parametrize("shape", SHAPES)
def test_diffusion_matches_f64_oracle(shape):
    w, _ = _fields(shape, 2)
    got = diffusion_timestep_vector_3d(jnp.asarray(w), 0.37)
    np.testing.assert_allclose(np.asarray(got), np_diffusion(w, 0.37),
                               atol=1e-13)


@pytest.mark.parametrize("shape", SHAPES)
def test_curl_with_free_stream_matches_f64_oracle(shape):
    w, _ = _fields(shape, 3)
    fsv = np.array([1.0, -0.5, 0.25])
    got = add_fixed_val(curl_3d(jnp.asarray(w), 0.25), jnp.asarray(fsv))
    want = np_curl(w, 0.25) + fsv[:, None, None, None]
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-13)


@pytest.mark.parametrize("shape", SHAPES)
def test_rotational_update_matches_f64_oracle(shape):
    w, u = _fields(shape, 4)
    got = update_vorticity_from_velocity_forcing_3d(
        jnp.asarray(w), cross_product_3d(jnp.asarray(u), jnp.asarray(w)),
        0.05,
    )
    want = w + np_curl(np.cross(u, w, axis=0), 0.05)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-13)


@pytest.mark.parametrize("width", [1, 2, 3])
@pytest.mark.parametrize("shape", [(12, 10, 16), (10, 32, 24), (7, 9, 11)])
def test_diffusion_then_penalise_matches_f64_oracle(shape, width):
    w, _ = _fields(shape, 5)
    got = penalise_field_boundary_vector_3d(
        diffusion_timestep_vector_3d(jnp.asarray(w), 0.21), width
    )
    want = np.stack([np_penalise(c, width) for c in np_diffusion(w, 0.21)])
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-13)


@pytest.mark.parametrize("kind", ["multiplicative", "convolution"])
@pytest.mark.parametrize("order", [1, 2, 5])
@pytest.mark.parametrize("shape", [(12, 8, 16), (7, 9, 11)])
def test_laplacian_filter_matches_f64_oracle(shape, order, kind):
    w, _ = _fields(shape, 6)
    got = laplacian_filter_vector_3d(jnp.asarray(w), order, kind)
    want = np.stack([np_laplacian_filter(c, order, kind) for c in w])
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-13)
